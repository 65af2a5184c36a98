"""Fused BatchNorm apply + ReLU (+ residual): the CUDA kernels' wrappers,
their plain versions and the autograd Function.

The port of deep_vision_tpu/ops/pallas/bn_act.py: `fused_scale_bias_act`
(`_fused3`/`_fused4` and their custom vjp) and `fused_bn_act`. The
kernels are `csrc/bn_act.cu`, whose header says what they replace, what
bounds them and what a faster version would do.

    y = act(x * scale + bias [+ residual])       act: "relu" or None

Tensors are the port's NCHW-indexed activations: x is (N, C) or
(N, C, H, W), scale and bias are (C,) float32, and the residual has x's
shape, dtype and strides. x is float32 or bfloat16; the arithmetic is
float32 and y is rounded once to x's dtype. The backward, as
`_bwd_common` computes it (bn_act.py:158): g' = g * [y > 0] (g when act
is None), dx = g' * scale and dres = g' in x's dtype, dscale = sum g' * x
and dbias = sum g' in float32 over every axis but C.

Routing is by device and nothing else: CPU tensors take `bn_act_plain` /
`bn_act_bwd_plain` inside the same autograd Function, CUDA tensors launch
the kernels or raise. There is no fallback from a kernel to a plain
version, and nothing is made contiguous on the caller's behalf: the
kernels take x in channels_last memory (channel = index mod C) or
contiguous NCHW (channel = (index / H*W) mod C), and refuse any other
stride pattern, dtype or device mix. The one exception is the gradient
autograd hands to the backward, whose layout the caller does not choose:
it is brought to x's layout first (a copy only when it differs).

`fused_scale_bias_act.launches` counts forward kernel launches and
`fused_scale_bias_act.backward_launches` backward ones (plain integers;
set them to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deep_vision_tpu_torch.ops.cuda import build

ACTS = ("relu", None)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: resident blocks per SM the element kernels' grids aim for (256 threads
#: each: 2048 threads, the SM's maximum)
BLOCKS_PER_SM = 8

_ARGTYPES = {
    "dvt_bn_act_threads": [],
    "dvt_bn_act_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "dvt_bn_act_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
    + [ctypes.c_int, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("bn_act")
    for fn, argtypes in _ARGTYPES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _bshape(x: torch.Tensor) -> Tuple[int, ...]:
    """Shape that broadcasts a (C,) vector over x's channel axis (dim 1)."""
    return (1, -1) + (1,) * (x.dim() - 2)


def _reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


# -- plain versions ----------------------------------------------------------

def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 act: Optional[str] = "relu") -> torch.Tensor:
    """`reference_scale_bias_act` in PyTorch: the kernel's operations in
    its order (x * scale + bias, + residual, ReLU, one rounding)."""
    v = x.float() * scale.view(_bshape(x)) + bias.view(_bshape(x))
    if residual is not None:
        v = v + residual.float()
    if act == "relu":
        v = torch.where(v < 0, 0.0, v)
    return v.to(x.dtype)


def bn_act_bwd_plain(x: torch.Tensor, scale: torch.Tensor, y: torch.Tensor,
                     g: torch.Tensor, act: Optional[str],
                     has_residual: bool):
    """`_bwd_common` in PyTorch -> (dx, dscale, dbias, dres or None)."""
    gf = g.float()
    if act == "relu":
        gf = torch.where(y > 0, gf, 0.0)
    dx = (gf * scale.view(_bshape(x))).to(x.dtype)
    dims = _reduce_dims(x)
    dscale = (gf * x.float()).sum(dims)
    dbias = gf.sum(dims)
    return dx, dscale, dbias, gf.to(x.dtype) if has_residual else None


# -- checks and launch plans -------------------------------------------------

def _check(x: torch.Tensor, scale: torch.Tensor,
           bias: Optional[torch.Tensor], residual: Optional[torch.Tensor],
           act: Optional[str]) -> None:
    if act not in ACTS:
        raise ValueError(f"unsupported act {act!r}")
    if x.dim() not in (2, 4):
        raise ValueError(f"x must be (N, C) or (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if tuple(t.shape) != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({c},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if residual is not None:
        _check_like(residual, x, "residual")


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal strides on every axis longer than 1 (the strides of a
    length-1 axis never address memory)."""
    return all(sa == sb for n, sa, sb in zip(a.shape, a.stride(), b.stride())
               if n > 1)


def _check_like(t: torch.Tensor, x: torch.Tensor, name: str) -> None:
    if (tuple(t.shape) != tuple(x.shape) or t.dtype != x.dtype
            or t.device != x.device):
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"does not match x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    if not same_layout(t, x):
        raise ValueError(f"{name} strides {t.stride()} differ from x's "
                         f"{x.stride()}: the kernels read both in one layout")


def layout(x: torch.Tensor) -> str:
    """"rows" (channel = index mod C: contiguous (N, C), or (N, C, H, W)
    in channels_last memory) or "planes" (contiguous NCHW); raises for
    any other stride pattern."""
    if x.dim() == 2 and x.is_contiguous():
        return "rows"
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return "rows"
    if x.dim() == 4 and x.is_contiguous():
        return "planes"
    raise ValueError(f"the bn_act kernels take channels_last or contiguous "
                     f"tensors; got shape {tuple(x.shape)} strides "
                     f"{x.stride()}")


def rows_plan(n: int, c: int, sm_count: int, threads: int) -> Tuple[int, int]:
    """(blocks, stride) of the rows layout: about BLOCKS_PER_SM blocks per
    SM (fewer when n is small, at least enough to cover C), and the
    largest multiple of C that the threads cover, so that each thread
    keeps one channel."""
    blocks = min(-(-n // threads), sm_count * BLOCKS_PER_SM)
    blocks = max(blocks, -(-c // threads))
    return blocks, (blocks * threads // c) * c


def planes_plan(planes: int, sm_count: int) -> int:
    return min(planes, sm_count * BLOCKS_PER_SM)


def _geometry(x: torch.Tensor):
    """(n, c, hw, planes_layout, blocks, stride, partial_rows)."""
    n, c = x.numel(), x.shape[1]
    hw = n // (x.shape[0] * c) if x.dim() == 4 else 1
    sms = _sm_count(x.device.index)
    if layout(x) == "rows":
        blocks, stride = rows_plan(n, c, sms, _lib().dvt_bn_act_threads())
        return n, c, hw, 0, blocks, stride, stride // c
    planes = n // hw
    return n, c, hw, 1, planes_plan(planes, sms), 0, planes // c


def _empty_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device)


# -- kernel launches ---------------------------------------------------------

def _launch_fwd(x, scale, bias, residual, act) -> torch.Tensor:
    y = _empty_like(x)
    if x.numel() == 0:
        return y  # nothing to compute: no launch
    n, c, hw, planes, blocks, stride, _ = _geometry(x)
    dev = x.device
    err = _lib().dvt_bn_act_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), n, c, hw, planes,
        DTYPES[x.dtype], int(act == "relu"), blocks, stride, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act forward kernel launch failed: "
                           f"cudaError_t {err}")
    fused_scale_bias_act.launches += 1
    return y


def _launch_bwd(x, scale, y, g, act, has_residual):
    dev = x.device
    dx = _empty_like(x)
    dres = _empty_like(x) if has_residual else None
    c = x.shape[1]
    dscale = torch.empty(c, dtype=torch.float32, device=dev)
    dbias = torch.empty(c, dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return dx, dscale.zero_(), dbias.zero_(), dres  # no launch
    n, c, hw, planes, blocks, stride, rows = _geometry(x)
    partial = torch.empty((rows, c, 2), dtype=torch.float32, device=dev)
    err = _lib().dvt_bn_act_bwd(
        g.data_ptr(), x.data_ptr(), y.data_ptr() if act == "relu" else None,
        scale.data_ptr(), dx.data_ptr(),
        None if dres is None else dres.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), n, c, hw, planes,
        DTYPES[x.dtype], int(act == "relu"), blocks, stride, rows, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act backward kernel launch failed: "
                           f"cudaError_t {err}")
    fused_scale_bias_act.backward_launches += 1
    return dx, dscale, dbias, dres


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_act runs on cpu or cuda, not {x.device}")
    return x.device.type


def bn_act_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   residual: Optional[torch.Tensor] = None,
                   act: Optional[str] = "relu") -> torch.Tensor:
    """The forward without autograd: CPU -> plain, CUDA -> kernel."""
    _check(x, scale, bias, residual, act)
    if _route(x) == "cpu":
        return bn_act_plain(x, scale, bias, residual, act)
    return _launch_fwd(x, scale, bias, residual, act)


def bn_act_backward(x: torch.Tensor, scale: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor, act: Optional[str], has_residual: bool):
    """The backward -> (dx, dscale, dbias, dres or None): CPU -> plain,
    CUDA -> kernel. g and y must share x's shape, dtype and strides."""
    _check(x, scale, None, None, act)
    _check_like(g, x, "g")
    _check_like(y, x, "y")
    if _route(x) == "cpu":
        return bn_act_bwd_plain(x, scale, y, g, act, has_residual)
    return _launch_bwd(x, scale, y, g, act, has_residual)


class _BnAct(torch.autograd.Function):
    """Saves (x, scale, y) like `_fused3_fwd`/`_fused4_fwd`."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, act):
        y = bn_act_forward(x, scale, bias, residual, act)
        ctx.save_for_backward(x, scale, y)
        ctx.act = act
        ctx.has_residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, y = ctx.saved_tensors
        if not same_layout(g, x):
            g = torch.empty_like(x).copy_(g)  # x's layout (see module doc)
        dx, dscale, dbias, dres = bn_act_backward(x, scale, y, g, ctx.act,
                                                  ctx.has_residual)
        return dx, dscale, dbias, dres, None


def fused_scale_bias_act(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor,
                         residual: Optional[torch.Tensor] = None,
                         act: Optional[str] = "relu") -> torch.Tensor:
    """y = act(x * scale + bias [+ residual]) in one pass; differentiable
    in x, scale, bias and residual."""
    return _BnAct.apply(x, scale, bias, residual, act)


fused_scale_bias_act.launches = 0
fused_scale_bias_act.backward_launches = 0


def fused_bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 gamma: torch.Tensor, beta: torch.Tensor, *,
                 epsilon: float = 1e-5,
                 residual: Optional[torch.Tensor] = None,
                 act: Optional[str] = "relu") -> torch.Tensor:
    """BN apply + act (+ residual) from raw statistics: folds (mean, var,
    gamma, beta) into per-channel (scale, bias), then the fused pass."""
    inv = gamma.float() * torch.rsqrt(var.float() + epsilon)
    b = beta.float() - mean.float() * inv
    return fused_scale_bias_act(x, inv, b, residual=residual, act=act)
