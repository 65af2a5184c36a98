"""The port's CUDA kernels against their plain versions on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode. This file imports neither JAX nor the JAX package, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

NMS and bn_act: equality is exact: the kernels are built without FMA
contraction or fast math and evaluate the plain versions' float32
operations in their order. The one exception is the bn_act backward's
channel sums (dscale, dbias), taken in another order than the plain
version's: they must agree within 1e-5 of the sum of |terms| per channel.

Flash attention sums its products in another order than the plain
versions (tiles of keys, tensor cores for bf16), so it is held to
tests/test_pallas.py's tolerances: float32 out and lse within rtol 2e-4,
atol 2e-5, float32 dq/dk/dv within rtol 2e-4, atol 2e-4 x the tensor's
largest magnitude (with scores scaled by 120, out within rtol 2e-3, atol
1e-4, as there, and dq/dk/dv within rtol 2e-3, atol 1e-3 x the largest
magnitude); bfloat16 out within 2e-2, bfloat16 dq/dk/dv within
2e-2 of the tensor's largest magnitude (the kernels round P and dS to
bf16 for their second products, where the plain versions keep float32).
lse is float32 in both and held to the float32 tolerance.

The norm kernels (csrc/norm.cu): the moments backward equals its plain
version bit for bit; the moments forward equals ops/cuda/norm.py's
`moments_order_model` (the model of its summation order, evaluated with
PyTorch's float32 ops) bit for bit, and the plain version within 1e-5 of
the sum of |terms| per channel (another order); a forward call launches
one kernel where one cluster covers each column chunk's rows (two, with
the combine, where it does not), a backward call one; LayerNorm within rtol and atol u + 2e-6 k (atol relative
to the compared tensor's largest magnitude; u is one bf16 ulp, 2^-7, for
a bf16 result, else 0; k the worst row's E[x^2] / (var + eps), the
cancellation the fast variance suffers), and its dscale and dbias, sums
over every row, within 1e-5 k of the sum of |terms|. Every norm kernel
repeats bit for bit.
"""
import pytest
import torch

from deep_vision_tpu_torch.ops.cuda.bn_act import (
    bn_act_backward,
    bn_act_bwd_plain,
    bn_act_forward,
    bn_act_plain,
    fused_scale_bias_act,
)
from deep_vision_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_backward,
    flash_bwd_plain,
    flash_delta,
    flash_dkv,
    flash_dq,
    flash_forward,
    flash_fwd_plain,
)
from deep_vision_tpu_torch.ops.cuda import nms, norm
from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms, nms_plain
from deep_vision_tpu_torch.ops.cuda.norm import (
    batch_moments,
    bn_moments_backward,
    bn_moments_bwd_coefficients,
    bn_moments_bwd_plain,
    bn_moments_forward,
    bn_moments_plain,
    layer_norm,
    layer_norm_backward,
    layer_norm_bwd_plain,
    layer_norm_forward,
    layer_norm_plain,
)
from deep_vision_tpu_torch.tools.nms_cases import (
    detections,
    edge_cases,
    large_cases,
)

NMS_CASES = edge_cases() + large_cases()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(1, 10_647, 100), (8, 10_647, 100),
                                   (2, 77, 100), (2, 70_000, 100),
                                   (3, 500, 0), (2, 0, 5)])
def test_nms_kernel_matches_plain(cuda_device, b, n, d):
    boxes, scores = detections(b + n, b, n)
    boxes = torch.from_numpy(boxes).to(cuda_device)
    scores = torch.from_numpy(scores).to(cuda_device)
    for thr in (0.0, 0.3, 0.5):
        before = greedy_nms.launches
        got = greedy_nms(boxes, scores, d, 0.5, thr)
        torch.cuda.synchronize()
        assert greedy_nms.launches == before + (1 if b and d else 0)
        want = nms_plain(boxes, scores, d, 0.5, thr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("k_pass", [4096, 64])
@pytest.mark.parametrize("case", range(len(NMS_CASES)),
                         ids=[c[0] for c in NMS_CASES])
def test_nms_kernel_edge_cases_match_plain(cuda_device, monkeypatch, case,
                                           k_pass):
    # the CPU model's cases (tests/test_torch_nms_tiles.py), on the card,
    # at the default K and at K = 64, where most cases take several passes
    label, boxes, scores, d, iou, thr = NMS_CASES[case]
    monkeypatch.setattr(nms, "PASS_CANDIDATES", k_pass)
    boxes = torch.from_numpy(boxes).to(cuda_device)
    scores = torch.from_numpy(scores).to(cuda_device)
    before = greedy_nms.launches
    got = greedy_nms(boxes, scores, d, iou, thr)
    torch.cuda.synchronize()
    assert greedy_nms.launches == before + 1
    want = nms_plain(boxes, scores, d, iou, thr)
    for g, w in zip(got, want):
        assert torch.equal(g, w), label


@pytest.mark.cuda
def test_nms_kernel_enqueues_without_host_sync(cuda_device):
    boxes, scores = detections(3, 8, 10_647)
    boxes = torch.from_numpy(boxes).to(cuda_device)
    scores = torch.from_numpy(scores).to(cuda_device)
    greedy_nms(boxes, scores, 100, 0.5, 0.5)  # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = greedy_nms(boxes, scores, 100, 0.5, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = nms_plain(boxes, scores, 100, 0.5, 0.5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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


def flash_inputs(dev, b, t, tk, h, d, dtype, seed, qk_scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(n):
        return torch.randn(b, n, h, d, generator=gen, device=dev)

    q = (draw(t) * qk_scale).to(dtype)
    return q, draw(tk).to(dtype), draw(tk).to(dtype), draw(t).to(dtype)


def flash_tolerance(dtype, grad=False, extreme=False):
    """(rtol, atol, atol relative to the largest |want|?) of the module
    doc; `extreme` (scores scaled by 120) is test_pallas.py's looser f32
    tolerance for that case (:50-57): near-one-hot rows, where a one-ulp
    difference between the two top scores moves the weights."""
    if dtype == torch.bfloat16:
        return (0.0, 2e-2, True) if grad else (2e-2, 2e-2, False)
    if extreme:
        return (2e-3, 1e-3, True) if grad else (2e-3, 1e-4, False)
    return (2e-4, 2e-4, True) if grad else (2e-4, 2e-5, False)


def assert_flash_close(got, want, dtype, name, grad=False, extreme=False):
    got, want = got.float(), want.float()
    rtol, atol, relative = flash_tolerance(dtype, grad, extreme)
    if relative:
        atol *= float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,tk,h,d,causal,qk_scale", [
    (2, 1024, 1024, 6, 64, False, 1.0),  # the ViT-S/16 512 shape, 2 images
    (2, 1000, 1000, 2, 64, True, 1.0),   # ragged T, causal
    (1, 77, 77, 3, 32, False, 1.0),
    (1, 100, 300, 2, 128, False, 1.0),   # cross attention
    (1, 300, 100, 2, 128, True, 1.0),    # causal, more queries than keys
    (1, 64, 200, 1, 8, True, 1.0),       # more keys than queries, D = 8
    (2, 130, 130, 2, 40, False, 1.0),    # D = 40 (computed at 64)
    (2, 128, 128, 2, 64, True, 120.0),   # extreme scores
    (1, 129, 65, 2, 64, False, 1.0),     # one row past 128, one key past 64
    (2, 1, 1024, 3, 64, False, 1.0),     # a single query
    (1, 256, 1024, 2, 64, True, 1.0),    # causal cross attention, Tq < Tk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda_device, b, t, tk, h, d, causal,
                                   qk_scale, dtype):
    q, k, v, g = flash_inputs(cuda_device, b, t, tk, h, d, dtype,
                              seed=t + tk + d, qk_scale=qk_scale)
    scale = d ** -0.5
    before = (flash_attention.launches, flash_attention.dq_launches,
              flash_attention.dkv_launches)
    out, lse = flash_forward(q, k, v, causal=causal)
    want_out, want_lse = flash_fwd_plain(q, k, v, causal, scale)
    extreme = qk_scale != 1.0
    assert out.dtype == dtype and lse.shape == (b, h, t)
    assert_flash_close(out, want_out, dtype, "out", extreme=extreme)
    torch.testing.assert_close(lse, want_lse, rtol=2e-4, atol=2e-5,
                               msg=lambda m: f"lse: {m}")
    shift = torch.randn(b, h, t, device=cuda_device)
    for delta_shift in (None, shift):
        got = flash_backward(q, k, v, want_out, want_lse, g, causal=causal,
                             delta_shift=delta_shift)
        want = flash_bwd_plain(q, k, v, want_out, want_lse, g, causal, scale,
                               delta_shift)
        for a, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert a.dtype == dtype
            assert_flash_close(a, w, dtype, name, grad=True, extreme=extreme)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches) == (before[0] + 1, before[1] + 2,
                                              before[2] + 2)


@pytest.mark.cuda
def test_flash_bf16_forward_and_dkv_repeat_bitwise(cuda_device):
    """The ViT step's shape: two calls give the same bits (no atomics;
    every sum in a fixed order)."""
    q, k, v, g = flash_inputs(cuda_device, 64, 1024, 1024, 6, 64,
                              torch.bfloat16, seed=11)
    out, lse = flash_forward(q, k, v)
    out2, lse2 = flash_forward(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    delta = flash_delta(out, g)
    dk, dv = flash_dkv(q, k, v, g, lse, delta)
    dk2, dv2 = flash_dkv(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.cuda
def test_flash_bf16_dq_repeats_bitwise(cuda_device):
    """The ViT step's shape: two dq calls give the same bits (dQ is summed
    in registers over the key tiles in order, no atomics)."""
    q, k, v, g = flash_inputs(cuda_device, 64, 1024, 1024, 6, 64,
                              torch.bfloat16, seed=13)
    out, lse = flash_forward(q, k, v)
    delta = flash_delta(out, g)
    before = flash_attention.dq_launches
    dq = flash_dq(q, k, v, g, lse, delta)
    dq2 = flash_dq(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert flash_attention.dq_launches == before + 2
    assert bool(torch.isfinite(dq).all()) and torch.equal(dq, dq2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_without_lse_gives_the_same_out(cuda_device, dtype):
    q, k, v, _ = flash_inputs(cuda_device, 2, 300, 300, 3, 64, dtype,
                              seed=12)
    before = flash_attention.launches
    out, lse = flash_forward(q, k, v, causal=True)
    bare, none = flash_forward(q, k, v, causal=True, need_lse=False)
    torch.cuda.synchronize()
    assert none is None and lse.shape == (2, 3, 300)
    assert torch.equal(out, bare)
    assert flash_attention.launches == before + 2


@pytest.mark.cuda
def test_flash_reads_the_qkv_projection_in_place(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 256, 3, 4, 64, generator=gen, device=cuda_device,
                      dtype=torch.bfloat16).requires_grad_()
    q, k, v = qkv.unbind(2)
    assert q.stride() == (256 * 3 * 4 * 64, 3 * 4 * 64, 64, 1)
    out = flash_attention(q, k, v)
    ref = flash_attention(*(t.detach().contiguous().requires_grad_()
                            for t in (q, k, v)))
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=gen, device=cuda_device,
                    dtype=out.dtype)
    out.backward(g)
    want = flash_bwd_plain(q.detach(), k.detach(), v.detach(),
                           *flash_fwd_plain(q.detach(), k.detach(),
                                            v.detach(), False, 0.125),
                           g, False, 0.125)
    for i, (w, name) in enumerate(zip(want, ("dq", "dk", "dv"))):
        assert_flash_close(qkv.grad[:, :, i], w, torch.bfloat16, name,
                           grad=True)


@pytest.mark.cuda
def test_flash_refuses_what_the_kernels_do_not_take(cuda_device):
    flat = torch.zeros(1 + 8 * 2 * 16, device=cuda_device)
    q = flat[1:].view(1, 8, 2, 16)  # 4-byte offset: rows not 16-byte aligned
    k = torch.zeros(1, 8, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        flash_forward(q, k, k)
    with pytest.raises(ValueError, match="on"):
        flash_forward(k, k.cpu(), k)


# -- norm --------------------------------------------------------------------

def norm_input(dev, shape, dtype, case, seed, channels_last=True):
    """normal draws; "offset": mean 30, std 1; "constant": every other
    channel (moments) or row (LayerNorm) 0.75."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev)
    if case == "offset":
        x += 30.0
    elif case == "constant" and len(shape) == 4 and channels_last:
        x[:, ::2] = 0.75
    elif case == "constant":
        x[..., ::2, :] = 0.75
    x = x.to(dtype)
    if len(shape) == 4 and channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def moments_plan_of(x):
    c = x.shape[1]
    return norm.moments_plan(x.numel() // c, c,
                             torch.cuda.get_device_properties(
                                 x.device).multi_processor_count,
                             x.element_size())


def kernels_per_call(fns):
    """The device kernels' names of each call in `fns`, from a profiler
    trace in which a spin kernel on the same stream frames each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            torch.cuda._sleep(1)
            fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    calls = []
    # the raw trace: events() drops a kernel whose launch kineto linked to
    # a CPU op it did not keep
    for e in sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns()):
        if "spin_kernel" in e.name():
            calls.append([])
        elif calls:
            calls[-1].append(e.name())
    assert len(calls) == len(fns) + 1 and not calls[-1]
    return calls[:-1]


def kappa(x):
    """The worst row's E[x^2] / (var + eps) over the last axis."""
    xd = x.double()
    return float((xd.square().mean(-1) / (xd.var(-1, unbiased=False)
                                          + 1e-6)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (16, 64, 56, 56), (32, 2048, 7, 7), (8, 256, 14, 14), (4, 12, 5, 5),
    (1, 64, 1, 1), (33, 100), (1, 2048), (3, 3, 17, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["normal", "offset", "constant"])
def test_bn_moments_kernels_match_plain(cuda_device, shape, dtype, case):
    x = norm_input(cuda_device, shape, dtype, case, seed=shape[1])
    c = shape[1]
    rows = x.numel() // c
    before = (batch_moments.launches, batch_moments.backward_launches)
    got = bn_moments_forward(x)
    want = bn_moments_plain(x)
    again = bn_moments_forward(x)
    xr = x.permute(0, 2, 3, 1).reshape(rows, c) if x.dim() == 4 else x
    model = norm.moments_order_model(xr, moments_plan_of(x))
    xd = xr.double()
    for k, terms in ((0, xd.abs()), (1, xd.square())):
        assert torch.equal(got[k], again[k])
        bound = 1e-5 * terms.mean(0).float()
        assert bool(((got[k] - want[k]).abs() <= bound).all())
        assert torch.equal(got[k], model[k])
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    u, w = (torch.randn(c, generator=gen, device=cuda_device)
            for _ in range(2))
    dx = bn_moments_backward(x, u, w)
    alpha, beta = bn_moments_bwd_coefficients(rows, u, w)
    assert dx.stride() == x.stride() and dx.dtype == x.dtype
    assert torch.equal(dx, bn_moments_bwd_plain(x, alpha, beta))
    assert torch.equal(dx, bn_moments_backward(x, u, w))
    torch.cuda.synchronize()
    assert (batch_moments.launches, batch_moments.backward_launches) == (
        before[0] + 2, before[1] + 2)


def assert_ln_close(got, want, name, bf16, k):
    tol = (2.0 ** -7 if bf16 else 0.0) + 2e-6 * k
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=tol,
                               atol=tol * float(want.abs().max()),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024, 384), (7, 384), (1, 384),
                                   (5, 3, 100), (4, 3), (2, 16, 1024),
                                   (3, 5, 776)])
@pytest.mark.parametrize("dtype,out", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("case", ["normal", "offset", "constant"])
def test_layer_norm_kernels_match_plain(cuda_device, shape, dtype, out,
                                        case):
    d = shape[-1]
    x = norm_input(cuda_device, shape, dtype, case, seed=d)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    s = torch.rand(d, generator=gen, device=cuda_device) + 0.5
    b = torch.randn(d, generator=gen, device=cuda_device)
    g = torch.randn(shape, generator=gen, device=cuda_device).to(out)
    k = kappa(x)
    before = (layer_norm.launches, layer_norm.backward_launches)
    y, mean, rstd = layer_norm_forward(x, s, b, 1e-6, out)
    wy, wmean, wrstd = layer_norm_plain(x, s, b, 1e-6, out)
    assert y.dtype == out
    assert_ln_close(y, wy, "y", out == torch.bfloat16, k)
    assert_ln_close(mean, wmean, "mean", False, k)
    assert_ln_close(rstd, wrstd, "rstd", False, k)
    dx, ds, db = layer_norm_backward(x, s, wmean, wrstd, g)
    wdx, wds, wdb = layer_norm_bwd_plain(x, s, wmean, wrstd, g)
    assert dx.dtype == dtype
    assert_ln_close(dx, wdx, "dx", dtype == torch.bfloat16, k)
    xhat = (x.double() - wmean.double()[..., None]) * wrstd.double()[..., None]
    rows = tuple(range(x.dim() - 1))
    for got, want, terms, name in (
            (ds, wds, (g.double() * xhat).abs().sum(rows), "dscale"),
            (db, wdb, g.double().abs().sum(rows), "dbias")):
        bound = 1e-5 * k * terms
        assert bool(((got - want).abs().double() <= bound).all()), name
    again = (layer_norm_forward(x, s, b, 1e-6, out),
             layer_norm_backward(x, s, wmean, wrstd, g))
    for a, w in zip((y, mean, rstd, dx, ds, db), (*again[0], *again[1])):
        assert torch.equal(a, w)
    torch.cuda.synchronize()
    assert (layer_norm.launches, layer_norm.backward_launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_norm_autograd_launches_the_kernels(cuda_device, monkeypatch):
    for name in ("bn_moments_plain", "bn_moments_bwd_plain",
                 "layer_norm_plain", "layer_norm_bwd_plain"):
        monkeypatch.setattr(norm, name, lambda *a, _n=name: pytest.fail(
            f"a CUDA tensor reached {_n}"))
    x = norm_input(cuda_device, (4, 64, 6, 6), torch.bfloat16, "normal",
                   seed=3).requires_grad_()
    t = norm_input(cuda_device, (2, 16, 384), torch.bfloat16, "normal",
                   seed=4).requires_grad_()
    s = torch.ones(384, device=cuda_device, requires_grad=True)
    b = torch.zeros(384, device=cuda_device, requires_grad=True)
    counts = (batch_moments.launches, batch_moments.backward_launches,
              layer_norm.launches, layer_norm.backward_launches)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        e1, e2 = batch_moments(x)
        (e1.sum() + e2.sum()).backward()
        layer_norm(t, s, b, 1e-6, torch.bfloat16).float().sum().backward()
        torch.cuda.synchronize()
    assert (batch_moments.launches, batch_moments.backward_launches,
            layer_norm.launches, layer_norm.backward_launches) == tuple(
        n + 1 for n in counts)
    names = " ".join(e.name for e in prof.events())
    for kernel in ("bn_moments_fwd", "bn_moments_bwd", "layer_norm_fwd",
                   "layer_norm_bwd", "layer_norm_bwd_combine"):
        assert kernel in names, kernel
    ones = torch.ones(64, device=cuda_device).view(1, -1, 1, 1)
    n = x.numel() // 64
    want = (ones / n + 2 * ones / n * x.detach().float()).to(x.dtype)
    assert torch.equal(x.grad, want)
    assert x.grad.stride() == x.stride()
    assert torch.equal(b.grad, torch.full_like(b, 32.0))


@pytest.mark.cuda
def test_norm_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(2, 8, 3, 5, device=cuda_device)
    with pytest.raises(ValueError, match="channels_last"):
        bn_moments_forward(x)  # contiguous NCHW
    with pytest.raises(ValueError, match="channels_last"):
        bn_moments_backward(x, torch.zeros(8, device=cuda_device),
                            torch.zeros(8, device=cuda_device))
    flat = torch.zeros(1 + 6 * 8, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        bn_moments_forward(flat[1:].view(6, 8))
    s = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        layer_norm_forward(flat[1:].view(6, 8), s, s, 1e-6, torch.float32)
    with pytest.raises(ValueError, match="contiguous rows"):
        layer_norm_forward(torch.zeros(8, 6, device=cuda_device).t(), s, s,
                           1e-6, torch.float32)
    with pytest.raises(ValueError, match="scale on"):
        layer_norm_forward(torch.zeros(6, 8, device=cuda_device), s.cpu(), s,
                           1e-6, torch.float32)
    with pytest.raises(ValueError, match="1024 elements"):
        layer_norm_forward(torch.zeros(2, 1032, device=cuda_device),
                           torch.ones(1032, device=cuda_device),
                           torch.ones(1032, device=cuda_device), 1e-6,
                           torch.float32)


# -- the zoo's shapes ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 60, 7, 7), (16, 216, 7, 7),
                                   (16, 1024, 7, 7), (8, 32, 112, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zoo_shapes_bn_act_and_moments_match_plain(cuda_device, shape,
                                                   dtype):
    """MobileNet's and ShuffleNet's BatchNorm shapes (ShuffleNet's 60- and
    216-channel bottleneck and concat widths, MobileNet's 1024-channel
    head and 32-channel stem), channels_last as the models keep them:
    bn_act with ReLU and no residual, as those models fuse it, and the
    moments, under the rules above."""
    x = norm_input(cuda_device, shape, dtype, "normal", seed=shape[1])
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1] + 1)
    g = torch.randn(shape, generator=gen, device=cuda_device).to(
        dtype).contiguous(memory_format=torch.channels_last)
    c = shape[1]
    a = torch.rand(c, generator=gen, device=cuda_device) + 0.5
    b = torch.randn(c, generator=gen, device=cuda_device)
    y = bn_act_forward(x, a, b, None, "relu")
    want_y = bn_act_plain(x, a, b, None, "relu")
    assert torch.equal(y, want_y) and y.stride() == x.stride()
    got = bn_act_backward(x, a, want_y, g, "relu", False)
    want = bn_act_bwd_plain(x, a, want_y, g, "relu", False)
    assert torch.equal(got[0], want[0])
    gf = torch.where(want_y > 0, g.float(), 0.0)
    for k, terms in ((1, gf * x.float()), (2, gf)):
        bound = 1e-5 * terms.abs().sum((0, 2, 3))
        assert bool(((got[k] - want[k]).abs() <= bound).all())
    rows = x.numel() // c
    mom, mom_plain = bn_moments_forward(x), bn_moments_plain(x)
    xd = x.permute(0, 2, 3, 1).reshape(rows, c).double()
    for k, terms in ((0, xd.abs()), (1, xd.square())):
        bound = 1e-5 * terms.mean(0).float()
        assert bool(((mom[k] - mom_plain[k]).abs() <= bound).all())
    u, w = (torch.randn(c, generator=gen, device=cuda_device)
            for _ in range(2))
    dx = bn_moments_backward(x, u, w)
    assert torch.equal(dx, bn_moments_bwd_plain(
        x, *bn_moments_bwd_coefficients(rows, u, w)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["avg", "max"])
@pytest.mark.parametrize("window,strides,padding", [
    (3, 1, "SAME"), (3, 2, "SAME"), (3, 2, "VALID"), (5, 3, "VALID")])
def test_zoo_pools_on_the_card_match_the_cpu(cuda_device, kind, window,
                                             strides, padding):
    """nn/layers.py's pools on channels_last card tensors against the
    same pools on the CPU, forward and input gradient, within 1e-6 of
    the largest magnitude (the window sums in another order). The
    library's own padded `F.avg_pool2d` fails this on the card (wrong
    input gradients for channels_last with padding), so `avg_pool` pads
    with F.pad."""
    from deep_vision_tpu_torch.nn.layers import avg_pool, max_pool

    pool = {"avg": avg_pool, "max": max_pool}[kind]
    gen = torch.Generator().manual_seed(window * 10 + strides)
    x = torch.randn(8, 192, 35, 35, generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        xx = x.to(dev).contiguous(memory_format=torch.channels_last)
        xx.requires_grad_()
        y = pool(xx, window, strides, padding)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
        (y * g.to(dev)).sum().backward()
        out[str(dev)] = (y.detach().cpu(), xx.grad.cpu())
    (y_card, dx_card), (y_cpu, dx_cpu) = out["cuda"], out["cpu"]
    for got, want in ((y_card, y_cpu), (dx_card, dx_cpu)):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


# -- detection training and V-MoE ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 1024, 13, 13), (16, 32, 416, 416)])
def test_yolov3_moments_shapes_match_plain(cuda_device, shape):
    """The moments at YOLOv3's smallest (2,704 rows of 1,024) and largest
    (2.77 M rows of 32) training BatchNorm shapes at the registered batch
    of 16, float32 channels_last, under the rules above."""
    x = norm_input(cuda_device, shape, torch.float32, "normal",
                   seed=shape[1])
    c = shape[1]
    rows = x.numel() // c
    got, want = bn_moments_forward(x), bn_moments_plain(x)
    assert all(torch.equal(g, a) for g, a in zip(got, bn_moments_forward(x)))
    xd = x.permute(0, 2, 3, 1).reshape(rows, c).double()
    for k, terms in ((0, xd.abs()), (1, xd.square())):
        bound = 1e-5 * terms.mean(0).float()
        assert bool(((got[k] - want[k]).abs() <= bound).all())
    del xd
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u, w = (torch.randn(c, generator=gen, device=cuda_device)
            for _ in range(2))
    assert torch.equal(bn_moments_backward(x, u, w), bn_moments_bwd_plain(
        x, *bn_moments_bwd_coefficients(rows, u, w)))


#: the 13 distinct BatchNorm input shapes of a YOLOv3 training step at
#: batch 16 and 416x416 (tests/test_torch_norm_plan.py reads them off the
#: port's model), from 2.77 M rows of 32 down to 2,704 rows of 1,024
YOLOV3_BN_SHAPES = [
    (16, 32, 416, 416), (16, 32, 208, 208), (16, 64, 208, 208),
    (16, 64, 104, 104), (16, 128, 104, 104), (16, 128, 52, 52),
    (16, 256, 52, 52), (16, 128, 26, 26), (16, 256, 26, 26),
    (16, 512, 26, 26), (16, 256, 13, 13), (16, 512, 13, 13),
    (16, 1024, 13, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", YOLOV3_BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_yolov3_step_moments_match_the_model_and_plain(cuda_device, shape,
                                                       dtype):
    """Every moments shape of the YOLOv3 step in float32 (the config's
    dtype) and bf16: the forward bit for bit the order model's and within
    1e-5 x mean |terms| of the plain version, the backward bit for bit
    the plain version's, both bit for bit on a second call."""
    x = norm_input(cuda_device, shape, dtype, "normal", seed=shape[1])
    c = shape[1]
    rows = x.numel() // c
    got, want = bn_moments_forward(x), bn_moments_plain(x)
    assert all(torch.equal(g, a) for g, a in zip(got, bn_moments_forward(x)))
    xr = x.permute(0, 2, 3, 1).reshape(rows, c)
    model = norm.moments_order_model(xr, moments_plan_of(x))
    for k in (0, 1):
        assert torch.equal(got[k], model[k])
        terms = (xr.float().abs() if k == 0 else xr.float().square()).mean(0)
        assert bool(((got[k] - want[k]).abs() <= 1e-5 * terms).all())
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    u, w = (torch.randn(c, generator=gen, device=cuda_device)
            for _ in range(2))
    dx = bn_moments_backward(x, u, w)
    assert torch.equal(dx, bn_moments_bwd_plain(
        x, *bn_moments_bwd_coefficients(rows, u, w)))
    assert torch.equal(dx, bn_moments_backward(x, u, w))


@pytest.mark.cuda
def test_moments_kernels_launch_once_a_call(cuda_device):
    """A backward call is one kernel, bn_moments_bwd, at every YOLOv3
    shape and at ResNet-50's stem (1.6 M rows of 64, bf16); a forward
    call is bn_moments_fwd alone where one cluster covers each chunk's
    rows (YOLOv3's 13x13, 26x26 and 52x52), and bn_moments_fwd then
    bn_moments_combine where the plan gives a chunk several clusters."""
    cases = [(shape, torch.float32) for shape in YOLOV3_BN_SHAPES]
    cases.append(((128, 64, 112, 112), torch.bfloat16))
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    fns, want = [], []
    for shape, dtype in cases:
        x = norm_input(cuda_device, shape, dtype, "normal", seed=5)
        u, w = (torch.randn(shape[1], generator=gen, device=cuda_device)
                for _ in range(2))
        plan = moments_plan_of(x)
        if shape[2] <= 52:
            assert plan.clusters == 1, (shape, plan)
        fns += [lambda x=x: bn_moments_forward(x),
                lambda x=x, u=u, w=w: bn_moments_backward(x, u, w)]
        want += [["bn_moments_fwd", "bn_moments_combine"][:plan.launches],
                 ["bn_moments_bwd"]]
    assert any(len(names) == 2 for names in want)
    for names, expect in zip(kernels_per_call(fns), want):
        assert len(names) == len(expect)
        assert all(e in n for e, n in zip(expect, names)), (names, expect)


@pytest.mark.cuda
def test_moments_forward_raises_on_a_refused_cluster_launch(cuda_device,
                                                             monkeypatch):
    """A cluster the kernel does not take (32 CTAs) is refused and the
    wrapper raises: no other route runs, and no result is returned."""
    x = norm_input(cuda_device, (16, 256, 13, 13), torch.float32, "normal",
                   seed=6)
    plan = moments_plan_of(x)._replace(cluster=32)
    monkeypatch.setattr(norm, "moments_plan", lambda *a: plan)
    before = batch_moments.launches
    with pytest.raises(RuntimeError, match="bn_moments forward"):
        bn_moments_forward(x)
    assert batch_moments.launches == before
    monkeypatch.undo()
    got = bn_moments_forward(x)  # the next call runs
    assert all(torch.isfinite(g).all() for g in got)


@pytest.mark.cuda
def test_yolov3_training_batchnorm_inputs_are_channels_last(cuda_device):
    """Every BatchNorm of a YOLOv3 training step gets a channels_last
    input (the moments kernels refuse any other 4-D layout), through
    the backbone, the neck's concatenations and upsampling, and the
    heads: 72 moments forward and 72 backward launches."""
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.nn.layers import BatchNorm

    model = get_model("yolov3", num_classes=20, device=cuda_device,
                      train=True)
    layouts = []
    handles = [m.register_forward_pre_hook(lambda mod, args: layouts.append(
        args[0].is_contiguous(memory_format=torch.channels_last)))
        for m in model.modules() if isinstance(m, BatchNorm)]
    before = (batch_moments.launches, batch_moments.backward_launches)
    x = torch.rand(2, 128, 128, 3, device=cuda_device)
    sum(o.float().square().mean() for o in model(x)).backward()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    assert len(layouts) == 72 and all(layouts)
    assert (batch_moments.launches - before[0],
            batch_moments.backward_launches - before[1]) == (72, 72)


@pytest.mark.cuda
def test_moe_scatter_back_repeats_bitwise(cuda_device):
    """A MoeMlp forward and backward on the card twice from the same
    inputs: outputs, gates and every gradient bit for bit (the rows go
    back by a gather, whose backward writes each row once)."""
    from deep_vision_tpu_torch.models.vit import MoeMlp

    mlp = MoeMlp(384, 8, 1536)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    mlp.to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(8, 196, 384, generator=gen, device=cuda_device)
    cot = torch.randn(8, 196, 384, generator=gen, device=cuda_device)
    runs = []
    for _ in range(2):
        xx = x.clone().requires_grad_()
        mlp.zero_grad()
        out, gates = mlp(xx)
        (out * cot).sum().backward()
        runs.append([out, gates, xx.grad] + [p.grad.clone()
                                             for p in mlp.parameters()])
    assert len(set(gates.argmax(-1).tolist())) > 1
    for a, b in zip(*runs):
        assert torch.equal(a, b)
