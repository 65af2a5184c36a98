"""The port's CUDA kernels against their plain versions on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode. This file imports neither JAX nor the JAX package, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Equality is exact: the kernel is built without FMA contraction or fast
math and evaluates the plain version's float32 operations in its order.
"""
import numpy as np
import pytest
import torch

from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms, nms_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernel has no CPU mode")
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
