"""A CPU model of the Hopper flash-attention tiling, held against the
plain versions and the JAX Pallas kernels.

`csrc/flash_attention.cu`'s bf16 forward (`flash_fwd_sm90`), dq
(`flash_dq_sm90`) and dK/dV (`flash_dkv_sm90`) cannot run here. This file models their arithmetic
tile by tile in PyTorch, with the kernels' constants and edge rules, so
the rules are rehearsed on the CPU before they run on the card:

- forward: a CTA owns 128 query rows, two warpgroups of 64, and walks key
  tiles of 128 (64 at D = 128; causal: only up to the tile of its last
  valid row);
  scores enter exp2 as s * (scale log2 e) - m2 with m2 the running max in
  log2 units; lse = (m2 + log2 max(l, 1e-20)) ln 2;
- dq: a CTA owns 128 query rows, two warpgroups of 64, and walks key
  tiles of 64 (32 at D = 128); causal: each warpgroup stops at the tile
  of its last valid row. P = exp2(s scale log2 e - lse log2 e) with lse
  log2 e and delta kept per row; dS / scale = P (dP - delta), and the
  scale is applied once, to dQ. Query rows >= T score 0 against lse 0
  and delta 0, so their dS is 0 with no mask;
- dK/dV: a CTA owns 128 keys, two warpgroups of 64 (64 keys, one
  warpgroup at D = 128), and walks query tiles of 64 (32 at D = 128) from
  the first one that sees its first key (causal);
  P^T = exp2(s^T scale log2 e - lse log2 e);
- masks only on the tiles that need them: keys >= Tk set to -inf on the
  ragged last key tile in the forward and P = 0 there in dq (zero-filled
  rows would score 0), P = 0 for
  queries >= T on the ragged last query tile, causal masks on diagonal
  tiles. The model asserts that every tile it leaves unmasked, and every
  tile the loops skip, needs no mask;
- P (forward, dK/dV), dS (dq) and dS^T (dK/dV) rounded to bf16 before
  the second products, as the kernels feed them to wgmma (`round_p`).

The model is the test's, not the package's. Tolerances:
- model without rounding against the plain versions and the JAX kernels
  (interpret mode, as tests/test_pallas.py runs them): test_pallas.py's
  float32 tolerances, out and lse rtol 2e-4, atol 2e-5 (:29-30), dq and
  dK/dV rtol 2e-4, atol 2e-4 (:105-107), as tests/test_torch_flash.py. Both
  sides are float32; they differ in summation order and in exp2 against
  exp (the folded scale rounds once more: ~1e-7 relative);
- model with bf16 rounding against the plain versions: the card's bf16
  tolerances (chip_smoke.py FLASH_TOL), out within 2e-2, dq and dK/dV
  within 2e-2 of the largest magnitude: one bf16 rounding of each P and
  dS term.
"""
import math

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
from deep_vision_tpu_torch.ops.cuda.flash_attention import (
    NEG_INF,
    flash_delta,
    flash_dkv_plain,
    flash_dq_plain,
    flash_fwd_plain,
)

Q_ROWS = 128  # query rows a forward CTA owns
WG_ROWS = 64  # of them (or of a dK/dV CTA's keys), a warpgroup's
DQ_STAGES = 4  # dq's ring of K/V tiles
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def key_tile(d: int) -> int:
    """The forward's key tile: 64 at D = 128 (D > 64 is computed at
    128), else 128."""
    return 64 if d > 64 else 128


def cta_keys(d: int) -> int:
    """Keys a dK/dV CTA owns: one warpgroup's 64 at D = 128, else 128."""
    return 64 if d > 64 else 128


def dq_key_tile(d: int) -> int:
    """dq's key tile: 32 at D = 128, else 64 (S, dP, dQ and the packed dS
    in registers)."""
    return 32 if d > 64 else 64


def query_tile(d: int) -> int:
    """dK/dV's query tile: 32 at D = 128, else 64."""
    return 32 if d > 64 else 64


def rows(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Rows [start, start + n) of (B, T, H, D) as (B, H, n, D), zeros
    past T (TMA's zero fill)."""
    out = torch.zeros(x.shape[0], x.shape[2], n, x.shape[3])
    part = x[:, start:start + n].permute(0, 2, 1, 3)
    out[:, :, :part.shape[2]] = part
    return out


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fwd_tiles(q, k, v, causal: bool, scale: float, round_p: bool):
    """(out, lse) as flash_fwd_sm90 computes them, in float32."""
    b, t, h, d = q.shape
    tk = k.shape[1]
    sl2 = scale * LOG2E
    bn = key_tile(d)
    out = torch.zeros(b, t, h, d)
    lse = torch.zeros(b, h, t)
    for q0 in range(0, t, Q_ROWS):
        nk = math.ceil(tk / bn)
        if causal:
            nk = min(nk, (min(q0 + Q_ROWS, t) - 1) // bn + 1)
        for qw in (q0, q0 + WG_ROWS):
            row = torch.arange(qw, qw + WG_ROWS)
            for k0 in range(nk * bn, tk, bn):  # skipped tiles
                key = torch.arange(k0, min(k0 + bn, tk))
                seen = (key[None, :] <= row[:, None]) & (row[:, None] < t)
                assert not seen.any(), "a skipped key tile is seen"
            qs = rows(q, qw, WG_ROWS)
            m = torch.full((b, h, WG_ROWS), -math.inf)
            l = torch.zeros(b, h, WG_ROWS)
            o = torch.zeros(b, h, WG_ROWS, d)
            for k0 in range(0, nk * bn, bn):
                key = torch.arange(k0, k0 + bn)
                s = qs @ rows(k, k0, bn).transpose(-1, -2)
                bad = (key[None, :] >= tk) | (
                    causal & (key[None, :] > row[:, None]))
                if k0 + bn > tk or (causal and k0 + bn - 1 > qw):
                    s = s.masked_fill(bad, -math.inf)
                else:
                    assert not bad.any(), "an unmasked tile needs a mask"
                m_new = torch.maximum(m, s.amax(-1) * sl2)
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m - m_use)
                p = torch.exp2(s * sl2 - m_use[..., None])
                l = l * alpha + p.sum(-1)
                p = bf16(p) if round_p else p
                o = o * alpha[..., None] + p @ rows(v, k0, bn)
                m = m_new
            l = torch.clamp_min(l, 1e-20)
            n = max(0, min(WG_ROWS, t - qw))
            out[:, qw:qw + n] = (o / l[..., None])[:, :, :n].permute(
                0, 2, 1, 3)
            lse[:, :, qw:qw + n] = ((m + torch.log2(l)) * LN2)[:, :, :n]
    return out, lse


def dq_probs(s, neg_lse2, bad, sl2):
    """dq's P: exp2 of one FFMA, then 0 where `bad` (by select, after the
    exponential, so no masked score or lse can turn into inf or NaN)."""
    p = torch.exp2(s * sl2 + neg_lse2[..., None])
    return p if bad is None else torch.where(bad, 0.0, p)


def dq_tiles(q, k, v, dout, lse, delta, causal: bool, scale: float,
             round_p: bool):
    """dq as flash_dq_sm90 computes it, in float32."""
    b, t, h, d = q.shape
    tk = k.shape[1]
    bn = dq_key_tile(d)
    sl2 = scale * LOG2E
    dq = torch.zeros(q.shape)
    for q0 in range(0, t, Q_ROWS):
        nk = math.ceil(tk / bn)
        if causal:
            nk = min(nk, (min(q0 + Q_ROWS, t) - 1) // bn + 1)
        for qw in (q0, q0 + WG_ROWS):
            row = torch.arange(qw, qw + WG_ROWS)
            nkw = (min(nk, (min(qw + WG_ROWS, t) - 1) // bn + 1) if causal
                   else nk)
            # the producer never waits for a stage this warpgroup skips
            assert nk - nkw <= WG_ROWS // bn < DQ_STAGES
            for k0 in range(nkw * bn, tk, bn):  # skipped key tiles
                key = torch.arange(k0, min(k0 + bn, tk))
                seen = (key[None, :] <= row[:, None]) & (row[:, None] < t)
                assert not seen.any(), "a skipped key tile is seen"
            n = max(0, min(WG_ROWS, t - qw))
            neg_lse2 = torch.zeros(b, h, WG_ROWS)
            dl = torch.zeros(b, h, WG_ROWS)
            neg_lse2[..., :n] = -lse[..., qw:qw + n] * LOG2E
            dl[..., :n] = delta[..., qw:qw + n]
            qs, dos = rows(q, qw, WG_ROWS), rows(dout, qw, WG_ROWS)
            acc = torch.zeros(b, h, WG_ROWS, d)
            for k0 in range(0, nkw * bn, bn):
                key = torch.arange(k0, k0 + bn)
                ks = rows(k, k0, bn)
                s = qs @ ks.transpose(-1, -2)
                dp = dos @ rows(v, k0, bn).transpose(-1, -2)
                bad = (key[None, :] >= tk) | (
                    causal & (key[None, :] > row[:, None]))
                if k0 + bn > tk or (causal and k0 + bn - 1 > qw):
                    p = dq_probs(s, neg_lse2, bad, sl2)
                else:
                    assert not bad.any(), "an unmasked tile needs a mask"
                    p = dq_probs(s, neg_lse2, None, sl2)
                ds = p * (dp - dl[..., None])
                assert torch.isfinite(ds).all()
                assert not ds[:, :, n:].any(), "a row past T has dS != 0"
                acc += (bf16(ds) if round_p else ds) @ ks
            dq[:, qw:qw + n] = (acc * scale)[:, :, :n].permute(0, 2, 1, 3)
    return dq


def dkv_tiles(q, k, v, dout, lse, delta, causal: bool, scale: float,
              round_p: bool):
    """(dk, dv) as flash_dkv_sm90 computes them, in float32."""
    b, t, h, d = q.shape
    tk = k.shape[1]
    bn = query_tile(d)
    sl2 = scale * LOG2E
    nq = math.ceil(t / bn)
    dk = torch.zeros(k.shape)
    dv = torch.zeros(k.shape)
    keys = cta_keys(d)
    for k0 in range(0, tk, keys):
        qt0 = min(k0 // bn, nq) if causal else 0
        for kw in range(k0, k0 + keys, WG_ROWS):
            key = torch.arange(kw, kw + WG_ROWS)
            for t0 in range(0, qt0 * bn, bn):  # skipped query tiles
                qpos = torch.arange(t0, min(t0 + bn, t))
                seen = (key[:, None] <= qpos[None, :]) & (key[:, None] < tk)
                assert not seen.any(), "a skipped query tile sees a key"
            ks, vs = rows(k, kw, WG_ROWS), rows(v, kw, WG_ROWS)
            dka = torch.zeros(b, h, WG_ROWS, d)
            dva = torch.zeros(b, h, WG_ROWS, d)
            for t0 in range(qt0 * bn, nq * bn, bn):
                qpos = torch.arange(t0, t0 + bn)
                inside = qpos < t
                cols = torch.arange(t0, min(t0 + bn, t))
                lse2 = torch.zeros(b, h, bn)
                dl = torch.zeros(b, h, bn)
                lse2[..., :len(cols)] = lse[..., cols] * LOG2E
                dl[..., :len(cols)] = delta[..., cols]
                qs, dos = rows(q, t0, bn), rows(dout, t0, bn)
                s_t = ks @ qs.transpose(-1, -2)
                dp_t = vs @ dos.transpose(-1, -2)
                p = torch.exp2(s_t * sl2 - lse2[..., None, :])
                bad = ~inside[None, :] | (
                    causal & (key[:, None] > qpos[None, :]))
                if t0 + bn > t or (causal and kw + WG_ROWS - 1 > t0):
                    p = p.masked_fill(bad, 0.0)
                else:
                    # keys >= Tk are not stored: they need no mask
                    assert not (bad & (key[:, None] < tk)).any(), (
                        "an unmasked tile needs a mask")
                ds = p * (dp_t - dl[..., None, :]) * scale
                if round_p:
                    p, ds = bf16(p), bf16(ds)
                dva += p @ dos
                dka += ds @ qs
            n = max(0, min(WG_ROWS, tk - kw))
            dk[:, kw:kw + n] = dka[:, :, :n].permute(0, 2, 1, 3)
            dv[:, kw:kw + n] = dva[:, :, :n].permute(0, 2, 1, 3)
    return dk, dv


def inputs(b, t, tk, h, d, seed, as_bf16=False):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, n, h, d).astype(np.float32)
              for n in (t, tk, tk, t)]
    ts = [torch.from_numpy(a) for a in arrays]
    if as_bf16:
        ts = [bf16(x) for x in ts]  # bf16 values, float32 arithmetic
    return ts


def close_to_max(got, want, frac, name):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=name)


SHAPES = [(1, 1), (77, 77), (129, 129), (256, 256)]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,tk", SHAPES)
def test_tile_model_matches_the_plain_versions(t, tk, causal, d):
    q, k, v, g = inputs(1, t, tk, 2, d, seed=t + d + causal)
    scale = d ** -0.5
    want_out, want_lse = flash_fwd_plain(q, k, v, causal, scale)
    out, lse = fwd_tiles(q, k, v, causal, scale, round_p=False)
    torch.testing.assert_close(out, want_out, **FWD)
    torch.testing.assert_close(lse, want_lse, **FWD)
    delta = flash_delta(want_out, g)
    want = flash_dkv_plain(q, k, v, g, want_lse, delta, causal, scale)
    got = dkv_tiles(q, k, v, g, want_lse, delta, causal, scale,
                    round_p=False)
    for a, w, name in zip(got, want, ("dk", "dv")):
        torch.testing.assert_close(a, w, **GRAD, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("t,tk,causal,d", [
    (129, 65, False, 64),    # one row past a 128-row tile, one key past 64
    (1, 256, False, 64),     # a single query
    (64, 256, True, 64),     # causal cross attention, Tq < Tk
    (200, 70, True, 32),     # causal, more queries than keys
    (96, 96, True, 128),     # D = 128: dK/dV query tiles of 32
])
def test_tile_model_on_ragged_and_cross_shapes(t, tk, causal, d):
    q, k, v, g = inputs(2, t, tk, 1, d, seed=t * tk + d)
    scale = d ** -0.5
    want_out, want_lse = flash_fwd_plain(q, k, v, causal, scale)
    out, lse = fwd_tiles(q, k, v, causal, scale, round_p=False)
    torch.testing.assert_close(out, want_out, **FWD)
    torch.testing.assert_close(lse, want_lse, **FWD)
    delta = flash_delta(want_out, g)
    want = flash_dkv_plain(q, k, v, g, want_lse, delta, causal, scale)
    got = dkv_tiles(q, k, v, g, want_lse, delta, causal, scale,
                    round_p=False)
    for a, w, name in zip(got, want, ("dk", "dv")):
        torch.testing.assert_close(a, w, **GRAD, msg=lambda m: f"{name}: {m}")
    if causal and t < tk:  # keys past the last query: seen by no row
        assert not got[0][:, t:].any() and not got[1][:, t:].any()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 77, 129, 256])
def test_tile_model_matches_the_pallas_kernels(t, causal, d):
    q, k, v, g = inputs(1, t, t, 2, d, seed=3 * t + d + causal)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    want_out, want_lse = jax_flash_lse(jq, jk, jv, causal=causal,
                                       interpret=True)
    want_lse = np.asarray(want_lse)[:, :, 0].reshape(1, 2, t)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal=causal,
                                                interpret=True), jq, jk, jv)
    _, want_dk, want_dv = vjp(jg)
    out, lse = fwd_tiles(q, k, v, causal, scale, round_p=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FWD)
    np.testing.assert_allclose(lse.numpy(), want_lse, **FWD)
    delta = flash_delta(out, g)
    dk, dv = dkv_tiles(q, k, v, g, lse, delta, causal, scale, round_p=False)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), **GRAD,
                               err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), **GRAD,
                               err_msg="dv")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(256, 64), (129, 32)])
def test_bf16_rounding_of_p_and_ds_stays_in_the_card_tolerance(t, d,
                                                                causal):
    q, k, v, g = inputs(2, t, t, 2, d, seed=t + d, as_bf16=True)
    scale = d ** -0.5
    want_out, want_lse = flash_fwd_plain(q, k, v, causal, scale)
    out, lse = fwd_tiles(q, k, v, causal, scale, round_p=True)
    np.testing.assert_allclose(bf16(out).numpy(), want_out.numpy(),
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, **FWD)  # lse: no rounded P
    delta = flash_delta(want_out, g)
    want = flash_dkv_plain(q, k, v, g, want_lse, delta, causal, scale)
    got = dkv_tiles(q, k, v, g, want_lse, delta, causal, scale,
                    round_p=True)
    unrounded = dkv_tiles(q, k, v, g, want_lse, delta, causal, scale,
                          round_p=False)
    for a, u, w, name in zip(got, unrounded, want, ("dk", "dv")):
        close_to_max(bf16(a).numpy(), w.numpy(), 2e-2, name)
        assert not torch.equal(a, u), f"{name}: P and dS were not rounded"


def test_exp2_with_the_folded_scale_is_the_natural_softmax():
    rng = np.random.RandomState(0)
    s = torch.from_numpy(rng.randn(4, 300).astype(np.float32)) * 8.0
    scale = 64 ** -0.5
    sl2 = scale * LOG2E
    m2 = s.amax(-1, keepdim=True) * sl2
    p2 = torch.exp2(s * sl2 - m2)
    l2 = p2.sum(-1)
    lse = (m2.squeeze(-1) + torch.log2(l2)) * LN2
    torch.testing.assert_close(lse, torch.logsumexp(s * scale, -1), **FWD)
    torch.testing.assert_close(p2 / l2[:, None],
                               torch.softmax(s * scale, -1), **FWD)


def jax_dq(q, k, v, g, causal, g_lse=None):
    """dq from the Pallas kernels in interpret mode: through the
    reference's vjp, with an lse cotangent when `g_lse` is given."""
    b, t, h, _ = q.shape
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    if g_lse is None:
        _, vjp = jax.vjp(lambda a: jax_flash(a, jk, jv, causal=causal,
                                             interpret=True), jq)
        return np.asarray(vjp(jg)[0])

    def loss(a):
        out, lse = jax_flash_lse(a, jk, jv, causal=causal, interpret=True)
        lse = lse[:, :, 0].reshape(b, h, t)  # (B*H, T, 128) -> (B, H, T)
        return jnp.vdot(out, jg) + jnp.vdot(lse, jnp.asarray(g_lse.numpy()))

    return np.asarray(jax.grad(loss)(jq))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,tk", SHAPES)
def test_dq_tile_model_matches_the_plain_version(t, tk, causal, d):
    q, k, v, g = inputs(1, t, tk, 2, d, seed=5 * t + d + causal)
    scale = d ** -0.5
    out, lse = flash_fwd_plain(q, k, v, causal, scale)
    delta = flash_delta(out, g)
    want = flash_dq_plain(q, k, v, g, lse, delta, causal, scale)
    got = dq_tiles(q, k, v, g, lse, delta, causal, scale, round_p=False)
    torch.testing.assert_close(got, want, **GRAD)


@pytest.mark.parametrize("t,tk,causal,d", [
    (129, 65, False, 64),    # one row past a 128-row CTA, one key past 64
    (1, 256, False, 64),     # a single query
    (64, 256, True, 64),     # causal cross: the second warpgroup is empty
    (200, 70, True, 32),     # causal, more queries than keys
    (96, 96, True, 128),     # D = 128: key tiles of 32
    (256, 256, True, 128),   # the first warpgroup skips two key tiles
    (100, 300, False, 128),  # cross attention, ragged at D = 128
])
def test_dq_tile_model_on_ragged_and_cross_shapes(t, tk, causal, d):
    q, k, v, g = inputs(2, t, tk, 1, d, seed=t * tk + d + 1)
    scale = d ** -0.5
    out, lse = flash_fwd_plain(q, k, v, causal, scale)
    shift = torch.from_numpy(
        np.random.RandomState(t).randn(2, 1, t).astype(np.float32))
    for delta_shift in (None, shift):  # with and without an lse cotangent
        delta = flash_delta(out, g, delta_shift)
        want = flash_dq_plain(q, k, v, g, lse, delta, causal, scale)
        got = dq_tiles(q, k, v, g, lse, delta, causal, scale, round_p=False)
        torch.testing.assert_close(got, want, **GRAD)


@pytest.mark.parametrize("lse_cotangent", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(1, 64), (77, 32), (129, 64), (256, 64),
                                 (64, 128)])
def test_dq_tile_model_matches_the_pallas_dq_kernel(t, d, causal,
                                                    lse_cotangent):
    q, k, v, g = inputs(1, t, t, 2, d, seed=7 * t + d + causal)
    scale = d ** -0.5
    g_lse = (torch.from_numpy(np.random.RandomState(t + 1).randn(
        1, 2, t).astype(np.float32)) if lse_cotangent else None)
    want = jax_dq(q, k, v, g, causal, g_lse)
    out, lse = fwd_tiles(q, k, v, causal, scale, round_p=False)
    delta = flash_delta(out, g, g_lse)
    got = dq_tiles(q, k, v, g, lse, delta, causal, scale, round_p=False)
    np.testing.assert_allclose(got.numpy(), want, **GRAD, err_msg="dq")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", [(256, 64), (129, 32), (160, 128)])
def test_bf16_rounding_of_ds_in_dq_stays_in_the_card_tolerance(t, d, causal):
    q, k, v, g = inputs(2, t, t, 2, d, seed=t + d + 2, as_bf16=True)
    scale = d ** -0.5
    out, lse = flash_fwd_plain(q, k, v, causal, scale)
    delta = flash_delta(out, g)
    want = flash_dq_plain(q, k, v, g, lse, delta, causal, scale)
    got = dq_tiles(q, k, v, g, lse, delta, causal, scale, round_p=True)
    unrounded = dq_tiles(q, k, v, g, lse, delta, causal, scale,
                         round_p=False)
    close_to_max(bf16(got).numpy(), want.numpy(), 2e-2, "dq")
    assert not torch.equal(got, unrounded), "dS was not rounded"


def test_dq_masks_after_the_exponential_so_a_masked_row_stays_finite():
    """A row whose every key is masked, with the lse a forward gives it
    (NEG_INF + log 1e-20): dq's select after exp2 gives P = 0, where
    masking the score before the exponential would overflow to inf."""
    scale = 64 ** -0.5
    sl2 = scale * LOG2E
    lse = torch.full((1, 1, 4), NEG_INF + math.log(1e-20))
    neg_lse2 = -lse * LOG2E
    s = torch.from_numpy(np.random.RandomState(9).randn(1, 1, 4, 64).astype(
        np.float32))
    bad = torch.ones(4, 64, dtype=torch.bool)
    for scores in (s, torch.zeros_like(s)):  # zero-filled keys score 0
        p = dq_probs(scores, neg_lse2, bad, sl2)
        assert torch.isfinite(p).all() and not p.any()
    masked_first = torch.exp2(torch.full_like(s, NEG_INF) * sl2
                              + neg_lse2[..., None])
    assert torch.isinf(masked_first).all()
