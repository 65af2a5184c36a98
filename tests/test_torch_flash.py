"""Port parity: deep_vision_tpu_torch/ops/cuda/flash_attention.py against
the JAX package's flash attention, on the CPU.

The port's entry points run their plain versions here (CPU tensors),
inside the same autograd Functions the card runs with the kernels. The
JAX side runs the Pallas forward and dq/dkv kernels in interpret mode, as
tests/test_pallas.py runs them, with blocks of 16 or 32, so its online
softmax spans several key blocks. Inputs are drawn with numpy from a seed
and handed to both sides.

Tolerances are tests/test_pallas.py's, each for the same reason:
- f32 forward: rtol 2e-4, atol 2e-5 (:29-30); f32 gradients rtol 2e-4,
  atol 2e-4 (:105-107). The plain versions evaluate the softmax densely,
  the reference blockwise: the same f32 arithmetic in another order.
- scores scaled by 120: rtol 2e-3, atol 1e-4 (:50-57), as there.
- bf16 inputs: out within 2e-2 (:82-85) of the reference, gradients within
  2e-2 of each tensor's largest magnitude: both sides round their bf16
  results once, from f32 sums taken in different orders.
- lse (f32): rtol 2e-4, atol 2e-5, as the forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from deep_vision_tpu.ops.pallas.flash_attention import (
    flash_attention_with_lse as jax_flash_lse,
)
from deep_vision_tpu_torch.core.knobs import KnobError
from deep_vision_tpu_torch.ops.cuda.flash_attention import (
    FLASH_MIN_TOKENS,
    flash_attention,
    flash_attention_with_lse,
    flash_bwd_plain,
    flash_forward,
    flash_fwd_plain,
    flash_min_tokens,
)

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def qkvg(b=2, t=64, h=2, d=32, tk=None, seed=0):
    """numpy q, k, v and an output cotangent g."""
    rng = np.random.RandomState(seed)
    tk = tk or t
    shapes = [(b, t, h, d), (b, tk, h, d), (b, tk, h, d), (b, t, h, d)]
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def jax_side(arrays, causal, block_q=16, block_k=16, dtype=jnp.float32):
    """Reference out and (dq, dk, dv) for the cotangent g."""
    q, k, v, g = (jnp.asarray(a, dtype) for a in arrays)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=block_q,
                         block_k=block_k)

    out, vjp = jax.vjp(f, q, k, v)
    grads = vjp(g)
    return (np.asarray(out, np.float32),
            [np.asarray(x, np.float32) for x in grads])


def port_side(arrays, causal, dtype=torch.float32):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_()
    out = flash_attention(q, k, v, causal=causal)
    out.backward(g)
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in (q, k, v)])


def close_to_max(got, want, frac, name):
    atol = frac * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_grads_match_the_pallas_kernels(causal):
    arrays = qkvg(b=2, t=64, h=2, d=8, seed=3)
    want_out, want = jax_side(arrays, causal, block_q=16, block_k=32)
    got_out, got = port_side(arrays, causal)
    np.testing.assert_allclose(got_out, want_out, **FWD)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)


def test_cross_attention_tq_ne_tk():
    arrays = qkvg(b=1, t=32, h=2, d=16, tk=64, seed=4)
    want_out, want = jax_side(arrays, False)
    got_out, got = port_side(arrays, False)
    assert got_out.shape == (1, 32, 2, 16) and got[1].shape == (1, 64, 2, 16)
    np.testing.assert_allclose(got_out, want_out, **FWD)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)


def test_causal_cross_attention_with_more_keys_than_queries():
    arrays = qkvg(b=1, t=32, h=1, d=8, tk=64, seed=5)
    want_out, want = jax_side(arrays, True)
    got_out, got = port_side(arrays, True)
    np.testing.assert_allclose(got_out, want_out, **FWD)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)
    # keys past the last query are seen by no row: their gradients are 0
    assert not got[1][:, 32:].any() and not got[2][:, 32:].any()


def test_extreme_scores_stay_finite_and_match():
    arrays = qkvg(b=2, t=64, h=2, d=32, seed=3)
    arrays[0] = arrays[0] * 120.0  # rows whose true max is far below 0
    want_out, _ = jax_side(arrays, True)
    got_out, _ = port_side(arrays, True)
    assert np.isfinite(got_out).all()
    np.testing.assert_allclose(got_out, want_out, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_io(causal):
    arrays = qkvg(b=2, t=32, h=2, d=32, seed=6)
    want_out, want = jax_side(arrays, causal, dtype=jnp.bfloat16)
    got_out, got = port_side(arrays, causal, dtype=torch.bfloat16)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-2, atol=2e-2)
    for a, b, name in zip(got, want, "qkv"):
        close_to_max(a, b, 2e-2, f"d{name}")


def test_lse_and_its_cotangent_match_the_reference():
    q, k, v, g = qkvg(b=2, t=32, h=2, d=16, seed=7)
    g_lse = np.random.RandomState(8).randn(2, 2, 32).astype(np.float32)

    def jax_loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, causal=True, block_q=16,
                                 block_k=16)
        lse = lse[:, :, 0].reshape(2, 2, 32)  # (B*H, T, 128) -> (B, H, T)
        return jnp.vdot(out, g) + jnp.vdot(lse, g_lse), lse

    (_, want_lse), want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash_attention_with_lse(qt, kt, vt, causal=True)
    assert lse.shape == (2, 2, 32) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               **FWD)
    loss = (out * torch.from_numpy(g)).sum() + (
        lse * torch.from_numpy(g_lse)).sum()
    loss.backward()
    for t, w, name in zip((qt, kt, vt), want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **GRAD)


def test_plain_versions_are_the_dense_softmax_and_its_autograd():
    q, k, v, g = (torch.from_numpy(a) for a in
                  qkvg(b=1, t=48, h=2, d=8, tk=40, seed=9))
    scale = 0.3
    out, lse = flash_fwd_plain(q, k, v, False, scale)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bthd,bshd->bhts", qr, kr) * scale
    dense = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), vr)
    np.testing.assert_allclose(out.numpy(), dense.detach().numpy(), **FWD)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, -1).detach().numpy(), **FWD)
    dense.backward(g)
    got = flash_bwd_plain(q, k, v, out, lse, g, False, scale)
    for a, t, name in zip(got, (qr, kr, vr), "qkv"):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(),
                                   err_msg=f"d{name}", **GRAD)


def test_cpu_routes_to_the_plain_versions_without_launches():
    q, k, v, _ = (torch.from_numpy(a) for a in qkvg(b=1, t=16, h=1, d=8))
    before = (flash_attention.launches, flash_attention.dq_launches,
              flash_attention.dkv_launches)
    out, lse = flash_forward(q, k, v, need_lse=False)
    assert lse is None and out.shape == q.shape
    for t in (q, k, v):
        t.requires_grad_()
    flash_attention(q, k, v).sum().backward()
    assert (flash_attention.launches, flash_attention.dq_launches,
            flash_attention.dkv_launches) == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "no_keys", "shape"])
def test_refuses_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 8, 2, 16)
    k = v = torch.zeros(1, 8, 2, 16)
    if bad == "head_dim":
        q = k = v = torch.zeros(1, 8, 2, 12)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "no_keys":
        k = v = torch.zeros(1, 0, 2, 16)
    else:
        k = torch.zeros(1, 8, 2, 8)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v)


def test_routing_floor_knob(monkeypatch):
    monkeypatch.delenv("DVT_FLASH_MIN_TOKENS", raising=False)
    assert flash_min_tokens() == FLASH_MIN_TOKENS == 1024
    monkeypatch.setenv("DVT_FLASH_MIN_TOKENS", "2048")
    assert flash_min_tokens() == 2048
    monkeypatch.setenv("DVT_FLASH_MIN_TOKENS", "2k")
    with pytest.raises(KnobError, match="DVT_FLASH_MIN_TOKENS"):
        flash_min_tokens()
