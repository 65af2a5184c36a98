"""Port parity: deep_vision_tpu_torch/ops/cuda/bn_act.py (plain forward,
plain backward, the autograd Function, fused_bn_act) against the JAX
`fused_scale_bias_act` run as its own tests run it on the CPU (the Pallas
kernel in interpret mode; C = 96 takes the reference's lax fallback),
and the wrapper's checks and launch plans, which need no card.

Inputs are drawn with numpy from a seed; both sides get the same
numbers, NHWC for JAX and the same memory as a channels_last NCHW view
for the port. bf16 inputs are the f32 draws rounded to nearest even on
both sides, so they are equal too.

Tolerances are those of tests/test_perf_fused.py:36-101: forward
rtol = atol = 1e-6 in f32 and 2e-2 in bf16 (one bf16 rounding);
gradients rtol = atol = 2e-5 (f32 channel sums taken in another order);
bf16 dx and dres 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.ops.pallas.bn_act import (
    fused_bn_act as jax_fused_bn_act,
    fused_scale_bias_act as jax_fused,
)
from deep_vision_tpu_torch.ops.cuda import bn_act
from deep_vision_tpu_torch.ops.cuda.bn_act import (
    bn_act_backward,
    bn_act_bwd_plain,
    bn_act_forward,
    bn_act_plain,
    fused_bn_act,
    fused_scale_bias_act,
)

SHAPE = (2, 4, 4)
FWD_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SUM_TOL = dict(rtol=2e-5, atol=2e-5)


def draws(c, seed, dtype, residual):
    """NHWC numpy f32 x (and r), scale in [0.5, 1.5), bias, cotangent g,
    and their JAX and torch (channels_last NCHW view) forms."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*SHAPE, c).astype(np.float32)
    a = (rng.rand(c) + 0.5).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    r = rng.randn(*SHAPE, c).astype(np.float32) if residual else None
    g = rng.randn(*SHAPE, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    def j(v):
        return None if v is None else jnp.asarray(v).astype(jdt)

    def t(v):
        return (None if v is None else
                torch.from_numpy(v).to(tdt).permute(0, 3, 1, 2))

    return (j(x), jnp.asarray(a), jnp.asarray(b), j(r), j(g),
            t(x), torch.from_numpy(a), torch.from_numpy(b), t(r), t(g))


def nhwc(t):
    return None if t is None else t.permute(0, 2, 3, 1).float().numpy()


def f32(a):
    return np.asarray(a, np.float32)


CASES = [(c, dt, res, act) for c in (64, 256, 96)
         for dt in ("float32", "bfloat16") for res in (False, True)
         for act in ("relu", None)]


@pytest.mark.parametrize("c,dtype,residual,act", CASES)
def test_plain_forward_matches_jax_kernel(c, dtype, residual, act):
    jx, ja, jb, jr, _, tx, ta, tb, tr, _ = draws(c, c, dtype, residual)
    want = jax_fused(jx, ja, jb, residual=jr, act=act, interpret=True)
    got = bn_act_plain(tx, ta, tb, tr, act)
    assert got.dtype == tx.dtype and got.stride() == tx.stride()
    np.testing.assert_allclose(nhwc(got), f32(want), **FWD_TOL[dtype])
    via_fn = fused_scale_bias_act(tx, ta, tb, residual=tr, act=act)
    assert torch.equal(via_fn, got)


@pytest.mark.parametrize("c,dtype,residual,act", CASES)
def test_plain_backward_matches_jax_vjp(c, dtype, residual, act):
    jx, ja, jb, jr, jg, tx, ta, tb, tr, tg = draws(c, c + 1, dtype, residual)
    if residual:
        _, vjp = jax.vjp(lambda x, a, b, r: jax_fused(
            x, a, b, residual=r, act=act, interpret=True), jx, ja, jb, jr)
    else:
        _, vjp = jax.vjp(lambda x, a, b: jax_fused(
            x, a, b, act=act, interpret=True), jx, ja, jb)
    want = vjp(jg)

    leaves = [t.clone().requires_grad_() for t in (tx, ta, tb)]
    if residual:
        leaves.append(tr.clone().requires_grad_())
    y = fused_scale_bias_act(*leaves[:3], residual=leaves[3] if residual
                             else None, act=act)
    y.backward(tg)
    names = ("x", "scale", "bias", "residual")
    for name, leaf, w in zip(names, leaves, want):
        got = leaf.grad
        assert got.dtype == leaf.dtype, name
        tol = FWD_TOL[dtype] if name in ("x", "residual") else SUM_TOL
        got = nhwc(got) if got.dim() == 4 else got.numpy()
        np.testing.assert_allclose(got, f32(w), err_msg=name, **tol)


def test_plain_backward_is_the_functions_backward():
    _, _, _, _, _, tx, ta, tb, tr, tg = draws(64, 5, "float32", True)
    y = bn_act_plain(tx, ta, tb, tr, "relu")
    dx, dscale, dbias, dres = bn_act_bwd_plain(tx, ta, y, tg, "relu", True)
    got = bn_act_backward(tx, ta, y, tg, "relu", True)
    for u, v in zip(got, (dx, dscale, dbias, dres)):
        assert torch.equal(u, v)
    # the mask is y > 0, the residual's gradient the masked g
    assert torch.equal(dres, torch.where(y > 0, tg, 0.0))


@pytest.mark.parametrize("residual", [False, True])
def test_fused_bn_act_matches_jax(residual):
    rng = np.random.RandomState(11)
    c = 64
    x = rng.randn(*SHAPE, c).astype(np.float32)
    stats = [rng.randn(c).astype(np.float32) * 0.1,
             rng.uniform(0.5, 1.5, c).astype(np.float32),
             rng.uniform(0.5, 1.5, c).astype(np.float32),
             rng.randn(c).astype(np.float32) * 0.1]
    r = rng.randn(*SHAPE, c).astype(np.float32) if residual else None
    want = jax_fused_bn_act(
        jnp.asarray(x), *map(jnp.asarray, stats),
        residual=None if r is None else jnp.asarray(r), interpret=True)
    to_t = lambda v: torch.from_numpy(v).permute(0, 3, 1, 2)  # noqa: E731
    got = fused_bn_act(to_t(x), *map(torch.from_numpy, stats),
                       residual=None if r is None else to_t(r))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_contiguous_nchw_and_2d_inputs_take_the_same_arithmetic():
    _, _, _, _, _, tx, ta, tb, tr, _ = draws(96, 3, "float32", True)
    want = bn_act_plain(tx, ta, tb, tr, "relu")
    nchw = bn_act_forward(tx.contiguous(), ta, tb, tr.contiguous(), "relu")
    assert nchw.is_contiguous()
    assert torch.equal(nchw, want)
    flat = bn_act_forward(tx[:, :, 0, 0].contiguous(), ta, tb, None, None)
    assert torch.equal(flat, tx[:, :, 0, 0] * ta + tb)


def test_cpu_calls_launch_nothing():
    before = (fused_scale_bias_act.launches,
              fused_scale_bias_act.backward_launches)
    _, _, _, _, _, tx, ta, tb, _, tg = draws(64, 4, "float32", False)
    x = tx.clone().requires_grad_()
    fused_scale_bias_act(x, ta, tb).backward(tg)
    assert (fused_scale_bias_act.launches,
            fused_scale_bias_act.backward_launches) == before


def test_layouts_from_strides():
    x = torch.zeros(2, 8, 3, 5)
    assert bn_act.layout(x) == "planes"
    assert bn_act.layout(x.to(memory_format=torch.channels_last)) == "rows"
    assert bn_act.layout(torch.zeros(4, 8)) == "rows"
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        bn_act.layout(x.transpose(2, 3))
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        bn_act.layout(x[:, ::2])


def test_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8, 3, 3)
    a, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="unsupported act"):
        fused_scale_bias_act(x, a, b, act="gelu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_scale_bias_act(x.half(), a, b)
    with pytest.raises(ValueError, match=r"scale must be float32 \(8,\)"):
        fused_scale_bias_act(x, torch.ones(7), b)
    with pytest.raises(ValueError, match="bias must be float32"):
        fused_scale_bias_act(x, a, b.double())
    with pytest.raises(ValueError, match="strides"):
        fused_scale_bias_act(x, a, b, residual=x.to(
            memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="does not match"):
        fused_scale_bias_act(x, a, b, residual=x.bfloat16())
    with pytest.raises(ValueError, match=r"\(N, C\) or \(N, C, H, W\)"):
        fused_scale_bias_act(torch.zeros(2, 8, 3), a, b)


@pytest.mark.parametrize("n,c", [(128 * 56 * 56 * 256, 256),
                                 (128 * 7 * 7 * 2048, 2048),
                                 (2 * 3 * 3 * 96, 96), (100, 100),
                                 (7 * 100, 100), (5, 1)])
def test_rows_plan_keeps_one_channel_per_thread(n, c):
    blocks, stride = bn_act.rows_plan(n, c, sm_count=132, threads=256)
    assert stride % c == 0 and c <= stride <= blocks * 256
    assert blocks <= max(132 * bn_act.BLOCKS_PER_SM, -(-c // 256))
    # the threads below the stride cover every element exactly once
    assert stride >= min(n, c)
    assert blocks * 256 - stride < c


def test_planes_plan_caps_the_grid():
    assert bn_act.planes_plan(10, 132) == 10
    assert bn_act.planes_plan(10 ** 6, 132) == 132 * bn_act.BLOCKS_PER_SM
