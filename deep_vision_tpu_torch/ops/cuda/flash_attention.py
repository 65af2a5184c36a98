"""Flash attention: the CUDA kernels' wrappers, their plain versions, the
two autograd Functions and the entry points.

The port of deep_vision_tpu/ops/pallas/flash_attention.py. The kernels
are `csrc/flash_attention.cu`, whose header says what they replace, what
bounds them and what a faster version would do.

    flash_attention(q, k, v, causal=False, scale=None) -> out
    flash_attention_with_lse(q, k, v, ...)              -> (out, lse)

q is (B, T, H, D), k and v are (B, Tk, H, D), float32 or bfloat16 alike;
out is (B, T, H, D) in q's dtype. The scores are q·k * scale (default
D ** -0.5), set to NEG_INF above the diagonal when causal, and the
arithmetic is float32. lse is the per-row logsumexp, (B, H, T) float32:
the reference returns it as (B*H, T, 128), broadcast across a 128-lane
minor axis for the TPU's tiling; `lse[b, h]` here is its
`lse[b * H + h, :, 0]`. Both entry points are differentiable, the second
in both outputs: an lse cotangent enters the backward as a shift of
delta = rowsum(dO * O), as `_flash_lse_bwd` folds it (:396-414).

Routing is by device and nothing else: CPU tensors take `flash_fwd_plain`
/ `flash_dq_plain` / `flash_dkv_plain` inside the same autograd
Functions, CUDA tensors launch the kernels or raise. There is no fallback
from a kernel to a plain version. The kernels take any T and Tk and any
D that is a multiple of 8 up to 128 (the reference's 512/1024 blocks and
its `t % block` assertion are TPU tiling constraints); q, k, v and dO may
be strided views with stride 1 on D (the slices of a fused qkv
projection are), 16-byte aligned. delta stays a PyTorch expression, as
the reference computes it in XLA outside Pallas.

`flash_attention.launches`, `.dq_launches` and `.dkv_launches` count the
forward, dq and dkv kernel launches (plain integers; set them to 0 to
start a count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deep_vision_tpu_torch.core import knobs
from deep_vision_tpu_torch.ops.cuda import build

NEG_INF = -1e30
#: below this many tokens the dense einsum runs (vit.py routes on it)
FLASH_MIN_TOKENS = 1024
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: B * H is the kernels' second grid axis
MAX_BATCH_HEADS = 65535

_COMMON = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
_ARGTYPES = {
    "dvt_flash_fwd": [ctypes.c_void_p] * 6 + _COMMON,
    "dvt_flash_dq": [ctypes.c_void_p] * 8 + _COMMON,
    "dvt_flash_dkv": [ctypes.c_void_p] * 9 + _COMMON,
}


def flash_min_tokens() -> int:
    """The routing floor, overridden by DVT_FLASH_MIN_TOKENS; a mistyped
    value raises (knobs.get_int)."""
    env = knobs.get_int("DVT_FLASH_MIN_TOKENS", default=None)
    return FLASH_MIN_TOKENS if env is None else env


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    for fn, argtypes in _ARGTYPES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# -- plain versions ----------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """(B, H, T, Tk) float32 scores, NEG_INF above the diagonal."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        t, tk = s.shape[-2:]
        above = (torch.arange(t, device=s.device)[:, None]
                 < torch.arange(tk, device=s.device)[None, :])
        s = s.masked_fill(above, NEG_INF)
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) in float32 as the kernel computes them: m = row max,
    l = sum exp(s - m), out = (exp(s - m) v) / max(l, 1e-20) rounded to
    q's dtype, lse = m + log(max(l, 1e-20))."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-20)
    out = torch.einsum("bhts,bshd->bthd", p, v.float())
    out = out / l.squeeze(-1).transpose(1, 2)[..., None]
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(q, k, lse, causal, scale) -> torch.Tensor:
    """P = exp(s - lse), 0 above the diagonal (exp(NEG_INF - lse))."""
    return torch.exp(_scores(q, k, causal, scale) - lse[..., None])


def _dscores(q, k, v, dout, lse, delta, causal, scale):
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bthd,bshd->bhts", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                   scale: float) -> torch.Tensor:
    """`_dq_kernel`: dq = Σ_k dS·K with dS = P (dP - delta) scale."""
    _, ds = _dscores(q, k, v, dout, lse, delta, causal, scale)
    return torch.einsum("bhts,bshd->bthd", ds, k.float()).to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_dkv_kernel`: dV = Σ_q Pᵀ dO, dK = Σ_q dSᵀ Q."""
    p, ds = _dscores(q, k, v, dout, lse, delta, causal, scale)
    dv = torch.einsum("bhts,bthd->bshd", p, dout.float()).to(v.dtype)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()).to(k.dtype)
    return dk, dv


def flash_delta(out: torch.Tensor, dout: torch.Tensor,
                delta_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, (B, H, T), minus the lse
    cotangent when one is given (`_flash_backward`, :293-302)."""
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if delta_shift is not None:
        delta = delta - delta_shift.float()
    return delta.contiguous()


def flash_bwd_plain(q, k, v, out, lse, dout, causal: bool, scale: float,
                    delta_shift: Optional[torch.Tensor] = None):
    """(dq, dk, dv) from the forward's (out, lse) and the gradient dO."""
    delta = flash_delta(out, dout, delta_shift)
    dq = flash_dq_plain(q, k, v, dout, lse, delta, causal, scale)
    return (dq,) + flash_dkv_plain(q, k, v, dout, lse, delta, causal, scale)


# -- checks and launches -----------------------------------------------------

def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, D), got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k and v must be (B, Tk, H, D) with q's B, H, D: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be float32 or bfloat16 alike, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernels take a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if k.shape[1] == 0 and q.shape[1] > 0:
        raise ValueError("no keys to attend to (Tk = 0)")


def _check_like(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if (t.shape != like.shape or t.dtype != like.dtype
            or t.device != like.device):
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"does not match {like.dtype} {tuple(like.shape)} "
                         f"on {like.device}")


def _check_rows(t: torch.Tensor, q: torch.Tensor, name: str) -> None:
    want = (q.shape[0], q.shape[2], q.shape[1])
    if (tuple(t.shape) != want or t.dtype != torch.float32
            or t.device != q.device):
        raise ValueError(f"{name} must be float32 (B, H, T) = {want} on "
                         f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def kernel_ready(t: torch.Tensor) -> bool:
    """Whether the kernels can read `t` as it lies: stride 1 on D, the
    base and the (batch, token, head) strides on 16-byte boundaries."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _strides(*ts: torch.Tensor):
    for name, t in zip(("q", "k", "v", "dout"), ts):
        if not kernel_ready(t):
            raise ValueError(
                f"{name} strides {t.stride()} at offset {t.data_ptr() % 16} "
                f"mod 16: the kernels take stride 1 on D and 16-byte "
                f"aligned rows")
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _common(q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float):
    b, t, h, d = q.shape
    dev = q.device
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"B * H = {b * h} exceeds {MAX_BATCH_HEADS}")
    return (b, h, t, k.shape[1], d, float(scale), int(causal),
            DTYPES[q.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"cudaError_t {err}")


def _launch_fwd(q, k, v, causal, scale, need_lse):
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if need_lse else None)
    if q.numel() == 0:
        return out, lse  # nothing to compute: no launch
    strides = _strides(q, k, v)
    _raise_on(_lib().dvt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), strides,
        *_common(q, k, causal, scale)), "forward")
    flash_attention.launches += 1
    return out, lse


def _launch_dq(q, k, v, dout, lse, delta, causal, scale):
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq
    strides = _strides(q, k, v, dout)
    _raise_on(_lib().dvt_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), strides,
        *_common(q, k, causal, scale)), "dq")
    flash_attention.dq_launches += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, causal, scale):
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if k.numel() == 0:
        return dk, dv
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()  # no queries: no launch
    strides = _strides(q, k, v, dout)
    _raise_on(_lib().dvt_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        strides, *_common(q, k, causal, scale)), "dkv")
    flash_attention.dkv_launches += 1
    return dk, dv


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_forward(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None, need_lse: bool = True):
    """The forward without autograd -> (out, lse or None): CPU -> plain,
    CUDA -> kernel (which skips the lse write when `need_lse` is False)."""
    _check(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, causal, scale)
        return out, lse if need_lse else None
    return _launch_fwd(q, k, v, causal, scale, need_lse)


def flash_dq(q, k, v, dout, lse, delta, *, causal: bool = False,
             scale: Optional[float] = None) -> torch.Tensor:
    """dq from lse and delta ((B, H, T) float32): CPU -> plain, CUDA ->
    kernel."""
    _check(q, k, v)
    _check_like(dout, q, "dout")
    _check_rows(lse, q, "lse")
    _check_rows(delta, q, "delta")
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, causal, scale)
    return _launch_dq(q, k, v, dout, lse, delta, causal, scale)


def flash_dkv(q, k, v, dout, lse, delta, *, causal: bool = False,
              scale: Optional[float] = None):
    """(dk, dv) from lse and delta: CPU -> plain, CUDA -> kernel."""
    _check(q, k, v)
    _check_like(dout, q, "dout")
    _check_rows(lse, q, "lse")
    _check_rows(delta, q, "delta")
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, causal, scale)
    return _launch_dkv(q, k, v, dout, lse, delta, causal, scale)


def flash_backward(q, k, v, out, lse, dout, *, causal: bool = False,
                   scale: Optional[float] = None,
                   delta_shift: Optional[torch.Tensor] = None):
    """(dq, dk, dv): delta in PyTorch, then the dq and dkv passes. A dO
    the kernels cannot read as it lies (autograd chooses its layout) is
    made contiguous first."""
    if dout.device.type == "cuda" and not kernel_ready(dout):
        dout = dout.contiguous()
    delta = flash_delta(out, dout, delta_shift)
    kw = dict(causal=causal, scale=scale)
    dq = flash_dq(q, k, v, dout, lse, delta, **kw)
    return (dq,) + flash_dkv(q, k, v, dout, lse, delta, **kw)


class _Flash(torch.autograd.Function):
    """`_flash`: out only; the lse is written only when a gradient will
    be needed (the reference's `need_lse=False` primal)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, need_grad):
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                                 need_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, causal=ctx.causal,
                                    scale=ctx.scale)
        return dq, dk, dv, None, None, None


class _FlashLse(torch.autograd.Function):
    """`_flash_lse`: (out, lse), differentiable in both; the lse
    cotangent shifts delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g_out,
                                    causal=ctx.causal, scale=ctx.scale,
                                    delta_shift=g_lse)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention. q (B, Tq, H, D); k, v (B, Tk, H, D) -> (B, Tq, H,
    D). Differentiable: the backward runs the dq and dkv kernels."""
    need_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _Flash.apply(q, k, v, bool(causal), _scale(q, scale), need_grad)


flash_attention.launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             scale: Optional[float] = None):
    """flash_attention that also returns the per-row logsumexp, (B, H, T)
    float32; differentiable in both outputs (the building block for
    blockwise merges, as in parallel/ring_attention.py)."""
    return _FlashLse.apply(q, k, v, bool(causal), _scale(q, scale))
