"""The port's CUDA kernels against their plain versions on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode. This file imports neither JAX nor the JAX package, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Equality is exact: the kernels are built without FMA contraction or fast
math and evaluate the plain versions' float32 operations in their order.
The one exception is the bn_act backward's channel sums (dscale, dbias),
taken in another order than the plain version's: they must agree within
1e-5 of the sum of |terms| per channel.
"""
import numpy as np
import pytest
import torch

from deep_vision_tpu_torch.ops.cuda.bn_act import (
    bn_act_backward,
    bn_act_bwd_plain,
    bn_act_forward,
    bn_act_plain,
    fused_scale_bias_act,
)
from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms, nms_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def detections(seed, b, n):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2).astype(np.float32) * 0.8
    wh = rng.rand(b, n, 2).astype(np.float32) * 0.25 + 0.02
    return np.concatenate([xy, xy + wh], -1), rng.rand(b, n).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(1, 10_647, 100), (8, 10_647, 100),
                                   (2, 77, 100), (2, 70_000, 100),
                                   (3, 500, 0), (2, 0, 5)])
def test_nms_kernel_matches_plain(cuda_device, b, n, d):
    boxes, scores = detections(b + n, b, n)
    boxes = torch.from_numpy(boxes).to(cuda_device)
    scores = torch.from_numpy(scores).to(cuda_device)
    for thr in (0.3, 0.5):
        before = greedy_nms.launches
        got = greedy_nms(boxes, scores, d, 0.5, thr)
        torch.cuda.synchronize()
        assert greedy_nms.launches == before + (1 if b and d else 0)
        want = nms_plain(boxes, scores, d, 0.5, thr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_nms_kernel_refuses_misaligned_boxes(cuda_device):
    flat = torch.zeros(1 + 2 * 8 * 4, device=cuda_device)
    boxes = flat[1:].view(2, 8, 4)  # 4-byte offset: not float4-aligned
    with pytest.raises(ValueError, match="16-byte"):
        greedy_nms(boxes, torch.zeros(2, 8, device=cuda_device), 5, 0.5, 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 9, 7), (2, 96, 5, 5),
                                   (3, 100, 7, 9), (2, 2048, 7, 7), (33, 100),
                                   (1, 1, 3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", [torch.channels_last,
                                 torch.contiguous_format])
def test_bn_act_kernels_match_plain(cuda_device, shape, dtype, fmt):
    gen = torch.Generator(device=cuda_device).manual_seed(
        len(shape) + shape[1])
    if len(shape) == 2 and fmt is torch.channels_last:
        fmt = torch.contiguous_format  # a 2-D tensor has one layout

    def draw():
        return torch.randn(shape, generator=gen, device=cuda_device).to(
            dtype).contiguous(memory_format=fmt)

    x, g, r = draw(), draw(), draw()
    c = shape[1]
    a = torch.rand(c, generator=gen, device=cuda_device) + 0.5
    b = torch.randn(c, generator=gen, device=cuda_device)
    dims = (0,) + tuple(range(2, len(shape)))
    for res in (None, r):
        for act in ("relu", None):
            y = bn_act_forward(x, a, b, res, act)
            want_y = bn_act_plain(x, a, b, res, act)
            assert torch.equal(y, want_y) and y.stride() == x.stride()
            got = bn_act_backward(x, a, want_y, g, act, res is not None)
            want = bn_act_bwd_plain(x, a, want_y, g, act, res is not None)
            assert torch.equal(got[0], want[0])
            if res is not None:
                assert torch.equal(got[3], want[3])
            gf = g.float()
            if act == "relu":
                gf = torch.where(want_y > 0, gf, 0.0)
            for k, terms in ((1, gf * x.float()), (2, gf)):
                bound = 1e-5 * terms.abs().sum(dims)
                assert bool(((got[k] - want[k]).abs() <= bound).all())


@pytest.mark.cuda
def test_bn_act_autograd_launches_the_kernels(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 16, 4, 4, generator=gen, device=cuda_device).to(
        memory_format=torch.channels_last).requires_grad_()
    r = torch.randn(2, 16, 4, 4, generator=gen, device=cuda_device).to(
        memory_format=torch.channels_last).requires_grad_()
    a = torch.ones(16, device=cuda_device, requires_grad=True)
    b = torch.zeros(16, device=cuda_device, requires_grad=True)
    fwd, bwd = (fused_scale_bias_act.launches,
                fused_scale_bias_act.backward_launches)
    y = fused_scale_bias_act(x, a, b, residual=r)
    y.sum().backward()  # an expanded gradient: brought to x's layout
    torch.cuda.synchronize()
    assert (fused_scale_bias_act.launches,
            fused_scale_bias_act.backward_launches) == (fwd + 1, bwd + 1)
    mask = ((x + r) > 0).float()
    assert torch.equal(x.grad, mask) and torch.equal(r.grad, mask)
    assert torch.equal(b.grad, mask.sum((0, 2, 3)))


@pytest.mark.cuda
def test_bn_act_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(2, 8, 3, 5, device=cuda_device)
    a = torch.ones(8, device=cuda_device)
    b = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        bn_act_forward(x.transpose(2, 3), a, b)
    with pytest.raises(ValueError, match="scale on"):
        bn_act_forward(x, a.cpu(), b)
    with pytest.raises(ValueError, match="does not match"):
        bn_act_forward(x, a, b, torch.zeros(2, 8, 3, 5))
