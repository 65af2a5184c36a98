"""BatchNorm batch moments and LayerNorm, forward and backward: the CUDA
kernels' wrappers, their plain versions and the autograd Functions.

The JAX package leaves both to XLA, which fuses each into passes that
read the tensor once: the training BatchNorm's statistics
(deep_vision_tpu/nn/layers.py:129-137, "one pass over x: f32
accumulation without an f32 materialization") and flax's `LayerNorm`
(deep_vision_tpu/models/vit.py:156, :158, :225). The kernels are
`csrc/norm.cu`, whose header says what bounds them and what a faster
version would do.

    batch_moments(x) -> (E[x], E[x^2])        f32 (C,) over every axis but C
    layer_norm(x, scale, bias, eps, out_dtype) -> y    over the last axis

`batch_moments` is only the O(N) part of BatchNorm's statistics: the
variance `max(E2 - E1^2, 0)`, the running update and the fold into
bn_act's (scale, bias) stay (C,)-sized PyTorch expressions in
nn/layers.py, so autograd differentiates the reference's algebra, the
clamp included. Its backward takes dE1, dE2 and writes
`dx = dE1 / N + (2 dE2 / N) * x` in x's dtype and layout.

`layer_norm` is flax's, in f32 whatever x's dtype: mean, the fast
variance `max(E[x^2] - mean^2, 0)`, `(x - mean) * (rsqrt(var + eps) *
scale) + bias`, rounded once to `out_dtype`. Its backward, with x̂ = (x -
mean) * rstd and h = g * scale per row:
`dx = (h - (mean(h) + x̂ * mean(h * x̂) * [E[x^2] - mean^2 >= 0])) * rstd`,
`dscale = sum g * x̂`, `dbias = sum g` over the rows. The bracket is the
clamp's mask as `torch.clamp_min`'s gradient takes it.

Routing is by device and nothing else: CPU tensors take the plain
versions inside the same autograd Functions, CUDA tensors launch the
kernels or raise. There is no fallback from a kernel to a plain version
and nothing is copied on the caller's behalf: the moments kernels take x
with C innermost (contiguous (N, C), or (N, C, H, W) in channels_last
memory), the LayerNorm kernels contiguous rows; both take float32 or
bfloat16 starting on a 16-byte boundary. The one exception is the
gradient autograd hands to a backward, whose layout the caller does not
choose: it is brought to the forward input's layout first (a copy only
when it differs).

`batch_moments.launches` / `.backward_launches` and `layer_norm.launches`
/ `.backward_launches` count kernel launches (plain integers; set them to
0 to start a count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from deep_vision_tpu_torch.ops.cuda import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: threads per block of every norm kernel (csrc/norm.cu's kThreads)
THREADS = 256
#: warps per block of the LayerNorm kernels, one row a warp at a time
LN_WARPS = THREADS // 32
#: the moments grid aims at this many blocks per SM ...
MOMENTS_BLOCKS_PER_SM = 4
#: ... but gives each thread at least this many rows to sum
MOMENTS_MIN_ROWS_PER_THREAD = 8
#: resident blocks per SM of the LayerNorm backward's persistent grid
LN_BWD_BLOCKS_PER_SM = 2
#: the combine kernels' block: COMBINE_COLS columns x COMBINE_GROUPS
#: groups of partial rows (csrc/column_sum.cuh's kColumnSumCols,
#: kColumnSumGroups)
COMBINE_COLS, COMBINE_GROUPS = 32, 8
#: a LayerNorm lane holds at most this many elements of its row, so a
#: row is at most 32 times as long
LN_MAX_ELEMS_PER_LANE = 32

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "dvt_norm_threads": [],
    "dvt_bn_moments_fwd": [_P] * 3 + [_LL] + [_I] * 6 + [_LL, _I, _P],
    "dvt_bn_moments_bwd": [_P] * 4 + [_LL] + [_I] * 5 + [_P],
    "dvt_layer_norm_fwd": [_P] * 6 + [_LL, _I, ctypes.c_float] + [_I] * 6
    + [_P],
    "dvt_layer_norm_bwd": [_P] * 9 + [_LL] + [_I] * 7 + [_P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("norm")
    for fn, argtypes in _ARGTYPES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if lib.dvt_norm_threads() != THREADS:
        raise RuntimeError("csrc/norm.cu and ops/cuda/norm.py disagree on "
                           "the block size")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def vector_width(n: int, elem_bytes: int) -> int:
    """Elements a thread loads at once: a 16-byte vector when `n` (C, or
    a row's length) is a multiple of it, else one element."""
    vec = 16 // elem_bytes
    return vec if n % vec == 0 else 1


# -- plain versions ----------------------------------------------------------

def bn_moments_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) in f32 per channel (dim 1) over every other axis:
    nn/layers.py's arithmetic before the kernel."""
    xf = x.float()
    dims = _reduce_dims(x)
    return xf.mean(dims), torch.square(xf).mean(dims)


def bn_moments_bwd_coefficients(n: int, d_mean: torch.Tensor,
                                d_mean2: torch.Tensor):
    """(alpha, beta), f32 (C,): dx = alpha + beta * x. beta = 2 dE2 / N,
    which rounds as (dE2 / N) * 2 does (a factor of 2 is exact)."""
    return d_mean.float() / n, 2 * d_mean2.float() / n


def bn_moments_bwd_plain(x: torch.Tensor, alpha: torch.Tensor,
                         beta: torch.Tensor) -> torch.Tensor:
    """dx = alpha + beta * x per channel, f32, rounded to x's dtype: the
    kernel's operations in its order, so equal to it bit for bit."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (alpha.view(shape) + beta.view(shape) * x.float()).to(x.dtype)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     out_dtype: torch.dtype):
    """flax's LayerNorm over the last axis -> (y in out_dtype, mean,
    rstd), mean and rstd f32 of shape x.shape[:-1]."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp_min(
        torch.square(xf).mean(-1, keepdim=True) - torch.square(mean), 0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * (rstd * scale) + bias
    return y.to(out_dtype), mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         g: torch.Tensor):
    """-> (dx in x's dtype, dscale, dbias in f32) from the saved mean and
    rstd; the clamp's mask is recomputed from E[x^2] as the forward
    computed it."""
    xf, gf = x.float(), g.float()
    mean, rstd = mean.unsqueeze(-1), rstd.unsqueeze(-1)
    keep = (torch.square(xf).mean(-1, keepdim=True)
            - torch.square(mean)) >= 0
    xhat = (xf - mean) * rstd
    h = gf * scale
    a = h.mean(-1, keepdim=True)
    b = torch.where(keep, (h * xhat).mean(-1, keepdim=True), 0.0)
    dx = ((h - (a + xhat * b)) * rstd).to(x.dtype)
    rows = tuple(range(x.dim() - 1))
    return dx, (gf * xhat).sum(rows), gf.sum(rows)


# -- launch plans ------------------------------------------------------------

class MomentsPlan(NamedTuple):
    """The moments kernel's grid. A block of THREADS threads covers
    `cols` vectors of `vec` channels of column chunk blockIdx.y, and
    `lanes` rows at a time: thread t is (lane t // cols, column t % cols),
    t < lanes * cols. Split blockIdx.x takes rows [s * rows_per_split,
    (s + 1) * rows_per_split); a thread sums its rows lane, lane + lanes,
    ... of the split in order, the block adds its lanes in order into one
    partial row, and the combine adds the partial rows (see
    `moments_order_model`)."""

    vec: int
    cols: int
    lanes: int
    col_blocks: int
    splits: int
    rows_per_split: int


@functools.lru_cache(maxsize=None)
def moments_plan(rows: int, c: int, sm_count: int,
                 elem_bytes: int = 2) -> MomentsPlan:
    """The grid for `rows` x `c` elements of `elem_bytes` each: about
    MOMENTS_BLOCKS_PER_SM blocks an SM, fewer when the rows would give a
    thread fewer than MOMENTS_MIN_ROWS_PER_THREAD. Many channels and few
    rows (C = 2048, 6,272 rows) give one row a block and many splits; few
    channels and many rows (C = 64, 1.6 M rows) 32 rows a block."""
    vec = vector_width(c, elem_bytes)
    vectors = c // vec
    cols = min(vectors, THREADS)
    lanes = THREADS // cols
    col_blocks = -(-vectors // cols)
    target = -(-sm_count * MOMENTS_BLOCKS_PER_SM // col_blocks)
    splits = max(1, min(target, -(-rows // (lanes
                                            * MOMENTS_MIN_ROWS_PER_THREAD))))
    per = max(1, -(-rows // splits))
    return MomentsPlan(vec, cols, lanes, col_blocks, -(-rows // per), per)


def moments_order_model(x: np.ndarray, plan: MomentsPlan):
    """(sum x, sum x^2), float32 (C,), of a (rows, C) array in the
    kernels' order, evaluated with numpy in float32 (each step rounded as
    the kernels round it: built with --fmad=false, so x * x and the add
    round apart). The kernels' sums equal these bit for bit."""
    x = np.asarray(x, np.float32)
    rows, c = x.shape
    lanes, per = plan.lanes, plan.rows_per_split
    pad = plan.splits * per - rows
    xs = np.concatenate([x, np.zeros((pad, c), np.float32)]).reshape(
        plan.splits, per, c)
    s = np.zeros((plan.splits, lanes, c), np.float32)
    q = np.zeros((plan.splits, lanes, c), np.float32)
    for k in range(-(-per // lanes)):  # a thread's k-th row: k*lanes + lane
        lo = k * lanes
        v = np.zeros((plan.splits, lanes, c), np.float32)
        v[:, :min(lanes, per - lo)] = xs[:, lo:lo + lanes]
        s += v  # rows past the end add 0.0, which changes no sum
        q += v * v
    parts = []
    for acc in (s, q):
        tot = acc[:, 0].copy()
        for lane in range(1, lanes):
            tot += acc[:, lane]
        parts.append(tot)  # (splits, C): the block's partial row
    out = []
    for part in parts:
        groups = [np.zeros(c, np.float32) for _ in range(COMBINE_GROUPS)]
        for j in range(plan.splits):
            groups[j % COMBINE_GROUPS] += part[j]
        tot = groups[0].copy()
        for grp in groups[1:]:
            tot += grp
        out.append(tot)
    return out[0], out[1]


class LayerNormPlan(NamedTuple):
    """The LayerNorm kernels' shape: a warp per row, each lane holding the
    row's vectors lane, lane + 32, ... (`per` slots of `vec` elements);
    the forward launches `fwd_blocks` blocks of LN_WARPS warps, one row a
    warp; the backward `bwd_blocks`, its warps walking the rows with a
    stride of bwd_blocks * LN_WARPS."""

    vec: int
    per: int
    fwd_blocks: int
    bwd_blocks: int


def ln_slots(vec: int) -> Tuple[int, ...]:
    """The `per` values csrc/norm.cu is built for at a vector width:
    powers of two up to LN_MAX_ELEMS_PER_LANE elements, and for single
    elements (a row not a multiple of 16 bytes, an edge case) 8 or 32."""
    if vec == 1:
        return (8, LN_MAX_ELEMS_PER_LANE)
    return tuple(p for p in (1, 2, 4, 8) if p * vec <= LN_MAX_ELEMS_PER_LANE)


@functools.lru_cache(maxsize=None)
def layer_norm_plan(rows: int, d: int, sm_count: int,
                    elem_bytes: int) -> LayerNormPlan:
    vec = vector_width(d, elem_bytes)
    need = -(-(d // vec) // 32)
    per = next((p for p in ln_slots(vec) if p >= need), None)
    if per is None:
        raise ValueError(
            f"the LayerNorm kernels keep a row in one warp's registers: at "
            f"most {32 * LN_MAX_ELEMS_PER_LANE} elements; got {d}")
    fwd = -(-rows // LN_WARPS)
    return LayerNormPlan(vec, per, fwd,
                         max(1, min(fwd, sm_count * LN_BWD_BLOCKS_PER_SM)))


# -- checks ------------------------------------------------------------------

def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"the norm kernels read 16-byte vectors: {name} "
                         f"must start on a 16-byte boundary")


def moments_rows(x: torch.Tensor) -> int:
    """Rows of the (rows, C) matrix the moments kernels read; raises for
    a layout other than C innermost (contiguous 2-D, channels_last 4-D)."""
    if x.dim() == 2 and x.is_contiguous():
        return x.shape[0]
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x.numel() // x.shape[1]
    raise ValueError(f"the moments kernels take (N, C) contiguous or "
                     f"(N, C, H, W) channels_last tensors; got shape "
                     f"{tuple(x.shape)} strides {x.stride()}")


def _check_vector(t: torch.Tensor, d: int, like: torch.Tensor,
                  name: str) -> None:
    if tuple(t.shape) != (d,) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 ({d},), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, x on {like.device}")


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the norm ops run on cpu or cuda, not {x.device}")
    return x.device.type


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


# -- moments -----------------------------------------------------------------

def _check_moments(x: torch.Tensor) -> None:
    if x.dim() not in (2, 4):
        raise ValueError(f"x must be (N, C) or (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    _check_dtype(x)


def bn_moments_forward(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) without autograd: CPU -> plain, CUDA -> kernel."""
    _check_moments(x)
    if _route(x) == "cpu":
        return bn_moments_plain(x)
    rows, c = moments_rows(x), x.shape[1]
    dev = x.device
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    if rows == 0:
        return out.fill_(float("nan")).unbind(0)  # as mean() of nothing
    _check_aligned(x, "x")
    plan = moments_plan(rows, c, _sm_count(dev.index), x.element_size())
    partial = torch.empty((plan.splits, 2, c), dtype=torch.float32,
                          device=dev)
    _raise_on(_lib().dvt_bn_moments_fwd(
        x.data_ptr(), partial.data_ptr(), out.data_ptr(), rows, c,
        DTYPES[x.dtype], plan.vec, plan.cols, plan.col_blocks, plan.splits,
        plan.rows_per_split, dev.index, _stream(dev)), "bn_moments forward")
    batch_moments.launches += 1
    return out[0], out[1]


def bn_moments_backward(x: torch.Tensor, d_mean: torch.Tensor,
                        d_mean2: torch.Tensor) -> torch.Tensor:
    """dx of (E[x], E[x^2]) for their cotangents, in x's dtype and
    layout: CPU -> plain, CUDA -> kernel."""
    _check_moments(x)
    c = x.shape[1]
    for name, t in (("d_mean", d_mean), ("d_mean2", d_mean2)):
        _check_vector(t, c, x, name)
    n = x.numel() // c if c else 0
    alpha, beta = bn_moments_bwd_coefficients(max(n, 1), d_mean, d_mean2)
    if _route(x) == "cpu":
        return bn_moments_bwd_plain(x, alpha, beta)
    rows = moments_rows(x)
    dx = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                             device=x.device)
    if rows == 0:
        return dx
    _check_aligned(x, "x")
    vec = vector_width(c, x.element_size())
    blocks = min(-(-x.numel() // (vec * THREADS)),
                 _sm_count(x.device.index) * MOMENTS_BLOCKS_PER_SM * 2)
    _raise_on(_lib().dvt_bn_moments_bwd(
        x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), dx.data_ptr(),
        x.numel(), c, DTYPES[x.dtype], vec, blocks, x.device.index,
        _stream(x.device)), "bn_moments backward")
    batch_moments.backward_launches += 1
    return dx


class _BnMoments(torch.autograd.Function):
    """x -> (E[x], E[x^2]); saves x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return bn_moments_forward(x)

    @staticmethod
    def backward(ctx, d_mean, d_mean2):
        (x,) = ctx.saved_tensors
        return bn_moments_backward(x, d_mean, d_mean2)


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (E[x], E[x^2]) per channel (dim 1) over every other axis;
    differentiable in x."""
    return _BnMoments.apply(x)


batch_moments.launches = 0
batch_moments.backward_launches = 0


# -- LayerNorm ---------------------------------------------------------------

def _check_layer_norm(x: torch.Tensor, out_dtype: torch.dtype,
                      **vectors: torch.Tensor) -> None:
    if x.dim() < 1:
        raise ValueError("x must have a last axis to normalise")
    _check_dtype(x)
    if out_dtype not in DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    for name, t in vectors.items():
        _check_vector(t, x.shape[-1], x, name)


def _ln_cuda_plan(x: torch.Tensor, **aligned: torch.Tensor) -> LayerNormPlan:
    if not x.is_contiguous():
        raise ValueError(f"the LayerNorm kernels take contiguous rows; got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    for name, t in dict(x=x, **aligned).items():
        _check_aligned(t, name)
    d = x.shape[-1]
    return layer_norm_plan(x.numel() // d, d, _sm_count(x.device.index),
                           x.element_size())


def layer_norm_forward(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float,
                       out_dtype: torch.dtype):
    """-> (y, mean, rstd) without autograd: CPU -> plain, CUDA -> kernel."""
    _check_layer_norm(x, out_dtype, scale=scale, bias=bias)
    if _route(x) == "cpu":
        return layer_norm_plain(x, scale, bias, eps, out_dtype)
    dev, d = x.device, x.shape[-1]
    y = torch.empty(x.shape, dtype=out_dtype, device=dev)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    plan = _ln_cuda_plan(x, scale=scale, bias=bias)
    _raise_on(_lib().dvt_layer_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), x.numel() // d, d, eps,
        DTYPES[x.dtype], DTYPES[out_dtype], plan.vec, plan.per,
        plan.fwd_blocks, dev.index, _stream(dev)), "layer_norm forward")
    layer_norm.launches += 1
    return y, mean, rstd


def layer_norm_backward(x: torch.Tensor, scale: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor,
                        g: torch.Tensor):
    """-> (dx, dscale, dbias): CPU -> plain, CUDA -> kernel. g has x's
    shape, in the forward's out_dtype; mean and rstd are the forward's."""
    _check_layer_norm(x, g.dtype, scale=scale)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (tuple(t.shape) != tuple(x.shape[:-1])
                or t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"{name} must be float32 {tuple(x.shape[:-1])}"
                             f" on {x.device}")
    if tuple(g.shape) != tuple(x.shape) or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")
    if _route(x) == "cpu":
        return layer_norm_bwd_plain(x, scale, mean, rstd, g)
    dev, d = x.device, x.shape[-1]
    dx = torch.empty_like(x)
    if x.numel() == 0:
        zero = torch.zeros(d, dtype=torch.float32, device=dev)
        return dx, zero, zero.clone()
    dscale = torch.empty(d, dtype=torch.float32, device=dev)
    dbias = torch.empty_like(dscale)
    if not (g.is_contiguous() and mean.is_contiguous()
            and rstd.is_contiguous()):
        raise ValueError("g, mean and rstd must be contiguous")
    plan = _ln_cuda_plan(x, g=g, scale=scale)
    partial = torch.empty((plan.bwd_blocks, 2, d), dtype=torch.float32,
                          device=dev)
    _raise_on(_lib().dvt_layer_norm_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), x.numel() // d, d,
        DTYPES[x.dtype], DTYPES[g.dtype], plan.vec, plan.per,
        plan.bwd_blocks, dev.index, _stream(dev)), "layer_norm backward")
    layer_norm.backward_launches += 1
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """x, scale, bias -> y; saves x, scale, mean and rstd."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        y, mean, rstd = layer_norm_forward(x, scale, bias, eps, out_dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        g = g.contiguous()  # x's layout (see module doc)
        dx, dscale, dbias = layer_norm_backward(x, scale, mean, rstd, g)
        return dx, dscale, dbias, None, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """flax's LayerNorm over the last axis, returned in `out_dtype`;
    differentiable in x, scale and bias."""
    return _LayerNorm.apply(x, scale, bias, eps, out_dtype)


layer_norm.launches = 0
layer_norm.backward_launches = 0
