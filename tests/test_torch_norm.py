"""Port parity: deep_vision_tpu_torch/ops/cuda/norm.py on its plain route
(the BatchNorm batch moments and LayerNorm autograd Functions, as CPU
tensors take them) against the JAX package on the CPU, forward and every
gradient; nn/layers.py's BatchNorm and LayerNorm, a ResNet bottleneck and
a ViT block through that route against the reference; and the wrapper's
checks and the profile's kernel names, which need no card.

Inputs are drawn with numpy from a seed and handed to both sides (NHWC
for JAX, the same memory as a channels_last NCHW view for the port);
bf16 inputs are the f32 draws rounded to nearest even on both sides.
The cases: normal rows, rows with |mean| >> std (mean 30, std 1), and
constant rows (value 0.75, whose sums are exact in any order, so the
variance is 0 on both sides).

Tolerances, each with its reason:
- moments forward: |port - reference| <= 1e-6 x the mean of |terms| per
  channel (E|x| for E[x], E[x^2] for E[x^2]): two f32 summation orders
  over at most 150 terms.
- LayerNorm forward and every gradient, and the moments' gradient:
  rtol and atol u + 2e-6 k, atol relative to the compared tensor's
  largest magnitude. u is 2^-7, one bf16 ulp, for a bf16 result, else 0:
  the port computes in f32 and rounds once, so an f32 difference in the
  last place can move a bf16 result by one ulp; and the reference rounds
  each partial cotangent of a bf16 input to bf16 before it adds them (x
  feeds the statistics and the normalisation through separate casts),
  which moves a gradient that cancels by a fraction of an ulp of its
  largest terms. k is the worst row's conditioning E[x^2] / (var + eps)
  (1 for the moments): the fast variance E[x^2] - mean^2 loses k ulps to
  cancellation, so the two sides' summation orders differ by that much
  in var, rstd and everything after (k ~ 1 for normal rows, ~1e3 with
  |mean| >> std; constant rows cancel exactly).
- the ResNet bottleneck and the ViT block: rtol 1e-4, atol 1e-4 x the
  largest magnitude, as tests/test_torch_resnet.py and
  tests/test_torch_vit.py hold the whole models (convolutions and
  matmuls sum in other orders); the bf16 ViT block 3e-2 x the largest
  magnitude, as the bf16 ViT there.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.models import resnet as jax_resnet
from deep_vision_tpu.models import vit as jax_vit
from deep_vision_tpu.nn.layers import BatchNorm as JaxBatchNorm
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.models import resnet, vit
from deep_vision_tpu_torch.nn.layers import BatchNorm, LayerNorm
from deep_vision_tpu_torch.ops.cuda import norm
from deep_vision_tpu_torch.ops.cuda.norm import (
    batch_moments,
    bn_moments_backward,
    bn_moments_bwd_coefficients,
    bn_moments_bwd_plain,
    bn_moments_forward,
    bn_moments_plain,
    layer_norm,
    layer_norm_backward,
    layer_norm_forward,
    layer_norm_plain,
)

EPS = 1e-6
BF16_ULP = 2.0 ** -7
CASES = ("normal", "offset", "constant")


def draw(case, shape, rng):
    """f32 numpy draws; the statistics run over every axis but the last
    for LayerNorm and every axis but the last (C) for the moments."""
    x = rng.randn(*shape).astype(np.float32)
    if case == "offset":
        x += 30.0
    elif case == "constant":
        x[..., ::2, :] = 0.75  # every other row (or image column) constant
    return x


def to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def nchw(t):
    return t.permute(0, 3, 1, 2)


def f32(a):
    return np.asarray(a.detach().float() if torch.is_tensor(a) else a,
                      np.float32)


def close(got, want, name, rounding=0.0, kappa=1.0):
    want = f32(want)
    tol = rounding + 2e-6 * kappa
    np.testing.assert_allclose(
        f32(got), want, rtol=tol,
        atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def kappa_rows(x):
    """The worst row's E[x^2] / (var + eps), in float64."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    return float((np.mean(x * x, -1) / (np.var(x, -1) + EPS)).max())


# -- moments -----------------------------------------------------------------

@pytest.mark.parametrize("c", [3, 96, 384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_moments_match_the_references_statistics(c, dtype, case):
    rng = np.random.RandomState(c)
    x = draw(case, (2, 3, 5, c), rng)
    u = rng.randn(c).astype(np.float32)
    w = rng.randn(c).astype(np.float32)

    def stats(xx):  # deep_vision_tpu/nn/layers.py:129-133
        xf = xx.astype(jnp.float32)
        return (jnp.mean(xf, axis=(0, 1, 2)),
                jnp.mean(jnp.square(xf), axis=(0, 1, 2)))

    (want1, want2), vjp = jax.vjp(stats, to_jax(x, dtype))
    (want_dx,) = vjp((jnp.asarray(u), jnp.asarray(w)))

    xt = nchw(to_torch(x, dtype)).clone(
        memory_format=torch.channels_last).requires_grad_()
    got1, got2 = batch_moments(xt)
    assert got1.dtype == got2.dtype == torch.float32
    xq = np.asarray(to_jax(x, dtype), np.float64)  # the rounded inputs
    for got, want, terms, name in (
            (got1, want1, np.abs(xq), "E[x]"),
            (got2, want2, xq * xq, "E[x^2]")):
        bound = 1e-6 * terms.mean(axis=(0, 1, 2))
        assert (np.abs(f32(got) - f32(want)) <= bound).all(), name
    assert torch.equal(torch.stack([got1, got2]),
                       torch.stack(bn_moments_plain(xt.detach())))
    (got1 * torch.from_numpy(u) + got2 * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == xt.dtype
    assert xt.grad.stride() == xt.stride()
    close(xt.grad.permute(0, 2, 3, 1), want_dx, "dx",
          rounding=BF16_ULP if dtype == "bfloat16" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_batchnorm_training_matches_the_reference(dtype, case):
    """The port's BatchNorm in training mode against the reference's, both
    with momentum 0, so the running statistics after the step are the
    batch's own: mean and clamped var, the output, and the gradients of
    x, scale and bias."""
    c = 96
    rng = np.random.RandomState(7)
    x = draw(case, (2, 4, 4, c), rng)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    cot = rng.randn(2, 4, 4, c).astype(np.float32)
    jm = JaxBatchNorm(momentum=0.0)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(c, np.float32),
                                 "var": np.ones(c, np.float32)}}

    def f(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), upd["batch_stats"]

    (_, stats), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        variables["params"], to_jax(x, dtype))
    want_y = jm.apply(variables, to_jax(x, dtype), mutable=["batch_stats"])[0]

    bn = BatchNorm(c).train()
    bn.MOMENTUM = 0.0
    bn.load_state_dict(variables_from_jax(variables))
    xt = nchw(to_torch(x, dtype)).clone(
        memory_format=torch.channels_last).requires_grad_()
    y = bn(xt)
    (y.float() * nchw(torch.from_numpy(cot))).sum().backward()
    rounding = BF16_ULP if dtype == "bfloat16" else 0.0
    # var divides by the batch std, which the offset case's fast variance
    # computes with ~1e3 ulps of cancellation (the same bound as LayerNorm)
    xq = np.asarray(to_jax(x, dtype), np.float64).reshape(-1, c).T
    k = kappa_rows(xq)
    close(bn.mean, stats["mean"], "mean", kappa=k)
    close(bn.var, stats["var"], "var", kappa=k)
    close(y.permute(0, 2, 3, 1), want_y, "y", rounding, k)
    close(xt.grad.permute(0, 2, 3, 1), gx, "dx", rounding, k)
    close(bn.scale.grad, gp["scale"], "dscale", kappa=k)
    close(bn.bias.grad, gp["bias"], "dbias", kappa=k)


def test_moments_backward_is_the_plain_version():
    rng = np.random.RandomState(3)
    x = nchw(torch.from_numpy(rng.randn(2, 3, 3, 16).astype(np.float32)))
    u = torch.from_numpy(rng.randn(16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16).astype(np.float32))
    alpha, beta = bn_moments_bwd_coefficients(18, u, w)
    want = bn_moments_bwd_plain(x, alpha, beta)
    assert torch.equal(bn_moments_backward(x, u, w), want)
    # autograd of the eager expressions it replaces gives the same bits
    xr = x.clone().requires_grad_()
    e1, e2 = xr.mean((0, 2, 3)), torch.square(xr).mean((0, 2, 3))
    (e1 * u + e2 * w).sum().backward()
    assert torch.equal(xr.grad, want)
    assert [torch.equal(a, b) for a, b in zip(
        bn_moments_forward(x), (e1, e2))] == [True, True]


# -- LayerNorm ---------------------------------------------------------------

@pytest.mark.parametrize("d", [3, 96, 384])
@pytest.mark.parametrize("dtype,out", [("float32", "float32"),
                                       ("bfloat16", "float32"),
                                       ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("case", CASES)
def test_layer_norm_matches_flax(d, dtype, out, case):
    rng = np.random.RandomState(d)
    x = draw(case, (2, 3, d), rng)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = rng.randn(d).astype(np.float32)
    cot = rng.randn(2, 3, d).astype(np.float32)
    jout = jnp.bfloat16 if out == "bfloat16" else jnp.float32

    def ref(xx, s, b):  # vit.py:156: LayerNorm(dtype=f32)(x).astype(...)
        return fnn.LayerNorm(dtype=jnp.float32).apply(
            {"params": {"scale": s, "bias": b}}, xx).astype(jout)

    want, vjp = jax.vjp(ref, to_jax(x, dtype), jnp.asarray(scale),
                        jnp.asarray(bias))
    want_dx, want_ds, want_db = vjp(jnp.asarray(cot).astype(jout))

    xt = to_torch(x, dtype).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = layer_norm(xt, st, bt, EPS, getattr(torch, out))
    assert y.dtype == getattr(torch, out)
    y.backward(torch.from_numpy(cot).to(y.dtype))
    k = kappa_rows(np.asarray(to_jax(x, dtype), np.float32))
    if case == "constant":
        k = kappa_rows(np.asarray(to_jax(x, dtype), np.float32)[:, 1::2])
    close(y, want, "y", BF16_ULP if out == "bfloat16" else 0.0, k)
    close(xt.grad, want_dx, "dx", BF16_ULP if dtype == "bfloat16" else 0.0,
          k)
    close(st.grad, want_ds, "dscale", kappa=k)
    close(bt.grad, want_db, "dbias", kappa=k)


def test_layer_norm_forward_saves_the_plain_statistics():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 7, 24).astype(np.float32) * 3 + 1)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, 24).astype(np.float32))
    b = torch.from_numpy(rng.randn(24).astype(np.float32))
    y, mean, rstd = layer_norm_forward(x, s, b, EPS, torch.bfloat16)
    assert mean.shape == rstd.shape == (4, 7)
    xd = x.double()
    np.testing.assert_allclose(mean.numpy(), xd.mean(-1).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        rstd.numpy(), (1 / torch.sqrt(xd.var(-1, unbiased=False) + EPS))
        .numpy(), rtol=1e-5)
    assert torch.equal(y, layer_norm_plain(x, s, b, EPS, torch.float32)[0]
                       .to(torch.bfloat16))
    g = torch.from_numpy(rng.randn(4, 7, 24).astype(np.float32))
    dx, ds, db = layer_norm_backward(x, s, mean, rstd, g)
    assert dx.dtype == torch.float32 and ds.shape == db.shape == (24,)
    assert torch.equal(db, g.sum((0, 1)))


def test_layer_norm_gradient_skips_the_clamped_variance():
    """A row whose E[x^2] - mean^2 rounds below 0 has var clamped to 0 and
    no gradient through it: dx = rstd * (h - mean(h)), as the autograd of
    the clamp gives it."""
    x = torch.full((1, 5), 0.7, dtype=torch.float32)
    mean = x.mean(-1, keepdim=True)
    diff = torch.square(x).mean(-1, keepdim=True) - torch.square(mean)
    assert float(diff) < 0  # 0.7 is not exact: the rounding goes negative
    s = torch.tensor([1.0, 2.0, 3.0, 0.5, 1.5])
    b = torch.zeros(5)
    g = torch.tensor([[0.5, -1.0, 2.0, 0.25, -0.75]])
    xr = x.clone().requires_grad_()
    sr = s.clone().requires_grad_()
    y = layer_norm(xr, sr, b, EPS, torch.float32)
    y.backward(g)
    # the eager expressions the kernel replaces, through autograd
    xe = x.clone().requires_grad_()
    m = xe.mean(-1, keepdim=True)
    var = torch.clamp_min(torch.square(xe).mean(-1, keepdim=True)
                          - torch.square(m), 0.0)
    ye = (xe - m) * (torch.rsqrt(var + EPS) * s) + b
    ye.backward(g)
    np.testing.assert_allclose(xr.grad.numpy(), xe.grad.numpy(), rtol=1e-6,
                               atol=1e-6 * float(xe.grad.abs().max()))
    h = g * s
    want = (h - h.mean()) * torch.rsqrt(var.detach() + EPS)
    np.testing.assert_allclose(xr.grad.numpy(), want.numpy(), rtol=1e-6)


def test_layernorm_module_rounds_its_out_dtype_once():
    rng = np.random.RandomState(9)
    ln = LayerNorm(32, dtype=torch.float32)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 32)
                                        .astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(rng.randn(32).astype(np.float32)))
    x = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32)).to(
        torch.bfloat16)
    g = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32)).to(
        torch.bfloat16)
    grads = []
    for fold in (True, False):
        xr = x.clone().requires_grad_()
        ln.zero_grad()
        y = ln(xr, out_dtype=torch.bfloat16) if fold else ln(xr).to(
            torch.bfloat16)
        y.backward(g)
        grads.append((y, xr.grad, ln.scale.grad.clone(),
                      ln.bias.grad.clone()))
    for a, b in zip(*grads):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ln(x).dtype == torch.float32


# -- the slices' blocks through the route ------------------------------------

def randomize(tree, rng):
    """Same structure, numpy leaves: kernels at 1/sqrt(fan_in), scales and
    variances in [0.5, 1.5), everything else ~ 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def block_close(got, want, name, rtol=1e-4):
    want = f32(want)
    np.testing.assert_allclose(f32(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-6), err_msg=name)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the plain versions' calls: the route each op took."""
    calls = {}
    for name in ("bn_moments_plain", "bn_moments_bwd_plain",
                 "layer_norm_plain", "layer_norm_bwd_plain"):
        fn = getattr(norm, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)

        monkeypatch.setattr(norm, name, counted)
    return calls


def test_resnet_bottleneck_through_the_moments_route(monkeypatch,
                                                     plain_calls):
    monkeypatch.setenv("DVT_PALLAS_FUSED", "1")  # as test_torch_resnet.py
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    jm = jax_resnet.BottleneckBlock(4, strides=(2, 2))
    tm = resnet.BottleneckBlock(8, 4, 2).to(memory_format=torch.channels_last)
    v = randomize(jax.device_get(jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), train=True)), rng)
    tm.load_state_dict(variables_from_jax(v))
    cot = rng.randn(2, 3, 3, 16).astype(np.float32)

    def f(params, xx):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm.train()
    before = (norm.batch_moments.launches,
              norm.batch_moments.backward_launches)
    xt = nchw(torch.from_numpy(x)).clone(
        memory_format=torch.channels_last).requires_grad_()
    out = tm(xt)
    (out * nchw(torch.from_numpy(cot))).sum().backward()
    # four BatchNorms (three ConvBNs and the tail): four moments, each
    # differentiated once
    assert plain_calls == {"bn_moments_plain": 4, "bn_moments_bwd_plain": 4}
    assert (norm.batch_moments.launches,
            norm.batch_moments.backward_launches) == before
    block_close(out.permute(0, 2, 3, 1), want, "output")
    block_close(xt.grad.permute(0, 2, 3, 1), gx, "input grad")
    params = dict(tm.named_parameters())
    for k, w in variables_from_jax({"params": jax.device_get(gp)}).items():
        block_close(params[k].grad, w, k)
    buffers = dict(tm.named_buffers())
    for k, w in variables_from_jax(
            {"batch_stats": jax.device_get(stats)}).items():
        block_close(buffers[k], w, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_block_through_the_layer_norm_route(dtype, plain_calls):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 32).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = jax_vit.ViTBlock(num_heads=2, dtype=jdt)
    tm = vit.ViTBlock(32, 2, dtype=getattr(torch, dtype))
    v = randomize(jax.device_get(jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x).astype(jdt))), rng)
    tm.load_state_dict(variables_from_jax(v))
    cot = rng.randn(2, 16, 32).astype(np.float32)

    def f(params, xx):
        out, _ = jm.apply({"params": params}, xx)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        v["params"], jnp.asarray(x).astype(jdt))
    xt = to_torch(x, dtype).requires_grad_()
    out = tm(xt)
    assert out.dtype == xt.dtype
    (out.float() * torch.from_numpy(cot)).sum().backward()
    # two LayerNorms, each rounding to the block's dtype in the op
    assert plain_calls == {"layer_norm_plain": 2, "layer_norm_bwd_plain": 2}
    if dtype == "bfloat16":
        block_close(out, want, "bf16 output", rtol=3e-2)
        return
    block_close(out, want, "output")
    block_close(xt.grad, gx, "input grad")
    params = dict(tm.named_parameters())
    for k, w in variables_from_jax({"params": jax.device_get(gp)}).items():
        block_close(params[k].grad, w, k)


# -- checks, plans and the profile's names -----------------------------------

def test_cpu_calls_launch_nothing():
    counts = (norm.batch_moments.launches,
              norm.batch_moments.backward_launches,
              norm.layer_norm.launches, norm.layer_norm.backward_launches)
    x = torch.randn(2, 8, 3, 3).to(
        memory_format=torch.channels_last).requires_grad_()
    sum(batch_moments(x)).sum().backward()
    y = torch.randn(4, 8, requires_grad=True)
    layer_norm(y, torch.ones(8), torch.zeros(8), EPS,
               torch.float32).sum().backward()
    assert (norm.batch_moments.launches,
            norm.batch_moments.backward_launches,
            norm.layer_norm.launches,
            norm.layer_norm.backward_launches) == counts


def test_moments_layout_from_strides():
    x = torch.zeros(2, 8, 3, 5)
    assert norm.moments_rows(x.to(memory_format=torch.channels_last)) == 30
    assert norm.moments_rows(torch.zeros(6, 8)) == 6
    for bad in (x, x.transpose(2, 3), torch.zeros(6, 16)[:, ::2]):
        with pytest.raises(ValueError, match="channels_last"):
            norm.moments_rows(bad)
    # the CPU route takes any layout: the plain version reads strides
    got = bn_moments_forward(x + torch.arange(8.0).view(1, 8, 1, 1))
    assert torch.equal(got[0], torch.arange(8.0))


def test_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        batch_moments(x.half())
    with pytest.raises(ValueError, match=r"\(N, C\) or \(N, C, H, W\)"):
        batch_moments(torch.zeros(2, 8, 3))
    with pytest.raises(ValueError, match=r"d_mean must be float32 \(8,\)"):
        bn_moments_backward(x, torch.zeros(7), torch.zeros(8))
    with pytest.raises(ValueError, match=r"scale must be float32 \(8,\)"):
        layer_norm(x, torch.ones(7), torch.zeros(8), EPS, torch.float32)
    with pytest.raises(ValueError, match="bias must be float32"):
        layer_norm(x, torch.ones(8), torch.zeros(8).double(), EPS,
                   torch.float32)
    with pytest.raises(TypeError, match="out_dtype"):
        layer_norm(x, torch.ones(8), torch.zeros(8), EPS, torch.float16)
    with pytest.raises(ValueError, match="does not match"):
        layer_norm_backward(x, torch.ones(8), torch.zeros(4), torch.ones(4),
                            torch.zeros(4, 7))


@pytest.mark.parametrize("d,elem,vec,per", [
    (384, 2, 8, 2), (384, 4, 4, 4), (768, 2, 8, 4), (96, 2, 8, 1),
    (100, 2, 1, 8), (1000, 4, 4, 8), (1024, 2, 8, 4), (3, 4, 1, 8),
    (1001, 2, 1, 32)])
def test_layer_norm_plan_keeps_a_row_in_one_warp(d, elem, vec, per):
    plan = norm.layer_norm_plan(65_536, d, 132, elem)
    assert (plan.vec, plan.per) == (vec, per)
    assert per in norm.ln_slots(vec)
    assert 32 * per * vec >= d and per * vec <= norm.LN_MAX_ELEMS_PER_LANE
    assert plan.fwd_blocks * norm.LN_WARPS >= 65_536
    assert plan.bwd_blocks == 132 * norm.LN_BWD_BLOCKS_PER_SM


def test_layer_norm_plan_refuses_rows_longer_than_a_warp_holds():
    with pytest.raises(ValueError, match="1024 elements"):
        norm.layer_norm_plan(8, 1032, 132, 2)
    assert norm.layer_norm_plan(3, 8, 132, 2).bwd_blocks == 1


def test_profile_groups_the_norm_kernels_by_name():
    from types import SimpleNamespace as Ns

    from deep_vision_tpu_torch.tools.profile_train import (
        RESNET_GROUPING,
        VIT_GROUPING,
        kernel_groups,
        kernels_by_group,
    )

    def op(name, kernels):  # launched outside any range or backward
        return Ns(name=name, cpu_parent=None, sequence_nr=-1,
                  kernels=[Ns(name=k, duration=d) for k, d in kernels])

    ns = "void (anonymous namespace)::"
    resnet_events = [
        op("_BnMoments", [(ns + "bn_moments_fwd<__nv_bfloat16, 8>(...)", 2.0),
                          (ns + "bn_moments_combine(...)", 1.0)]),
        op("_BnMomentsBackward",
           [(ns + "bn_moments_bwd<__nv_bfloat16, 8>(...)", 4.0)]),
        op("_BnActBackward", [(ns + "bwd_rows<...>(...)", 8.0),
                              (ns + "reduce_partials(...)", 16.0)]),
    ]
    got = kernel_groups(resnet_events, RESNET_GROUPING)
    assert (got["bn_stats"], got["bn_act_bwd"], got["other"]) == (7.0, 24.0,
                                                                  0.0)
    named = kernels_by_group(resnet_events, RESNET_GROUPING)
    assert named["bn_stats"] == {
        ns + "bn_moments_fwd<__nv_bfloat16, 8>(...)": 2.0,
        ns + "bn_moments_combine(...)": 1.0,
        ns + "bn_moments_bwd<__nv_bfloat16, 8>(...)": 4.0}
    vit_events = [
        op("_LayerNorm",
           [(ns + "layer_norm_fwd<__nv_bfloat16, __nv_bfloat16, 8, 2>(...)",
             2.0)]),
        op("_LayerNormBackward",
           [(ns + "layer_norm_bwd<float, float, 4, 4>(...)", 4.0),
            (ns + "layer_norm_bwd_combine(...)", 1.0)]),
        op("_Flash", [("void flash_fwd<__nv_bfloat16, 64>", 8.0)]),
    ]
    got = kernel_groups(vit_events, VIT_GROUPING)
    assert (got["layernorm"], got["flash_fwd"], got["other"]) == (7.0, 8.0,
                                                                  0.0)


def test_profile_host_time_by_range_and_backward_node():
    from types import SimpleNamespace as Ns

    from torch.autograd import DeviceType

    from deep_vision_tpu_torch.nn.layers import BN_STATS_RANGE
    from deep_vision_tpu_torch.tools.profile_train import (
        RESNET_GROUPING,
        host_by_range,
    )

    def op(name, us, parent=None, seq=-1, device=DeviceType.CPU):
        return Ns(name=name, cpu_parent=parent, sequence_nr=seq,
                  cpu_time_total=us, kernels=[], device_type=device)

    ranges = [op(BN_STATS_RANGE, 40.0), op(BN_STATS_RANGE, 60.0)]
    events = ranges + [
        op(BN_STATS_RANGE, 0.0, device=DeviceType.CUDA),  # its annotation
        op("_BnMoments", 30.0, ranges[0], seq=3),
        op("aten::clamp_min", 5.0, ranges[0], seq=4),
        op("_BnMoments", 50.0, ranges[1], seq=9),
        op("autograd::engine::evaluate_function: _BnMomentsBackward", 20.0,
           seq=3),
        op("autograd::engine::evaluate_function: ClampMinBackward0", 8.0,
           seq=4),
        op("autograd::engine::evaluate_function: _BnMomentsBackward", 22.0,
           seq=9),
        op("autograd::engine::evaluate_function: ConvolutionBackward0", 90.0,
           seq=2),
        op("aten::cudnn_convolution", 70.0, seq=2),
    ]
    assert host_by_range(events, RESNET_GROUPING) == {
        "bn_stats": {"forward": (100.0, 2), "backward": (50.0, 3)}}
