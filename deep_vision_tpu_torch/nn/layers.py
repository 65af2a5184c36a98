"""The port of deep_vision_tpu/nn/layers.py (ConvBN, BatchNorm,
DepthwiseSeparableConv, LocalResponseNorm, channel_shuffle) and the flax
layers the models use beside them: Conv, ConvTranspose,
Dense/DenseGeneral, LayerNorm, Dropout, max/avg pooling with flax's
padding, reflect padding, instance normalisation and nearest 2x
upsampling.

Layout: modules take and return NCHW-indexed tensors (PyTorch's
convolution layout), in whatever memory format they are given; the
models keep the JAX package's NHWC at their public edge, and ResNet runs
channels_last throughout (its NHWC input, permuted, already is).

Where the port must not follow PyTorch's habits:

- `BatchNorm` keeps the reference's arithmetic, in f32, with `scale`/
  `bias` as parameters and `mean`/`var` as buffers under the flax names,
  so bridged variables (convert.py) load one to one. In training mode
  the batch statistics are `mean = E[x]` and the biased "fast" variance
  `max(E[x^2] - mean^2, 0)`, and the running update is
  `ra = 0.9 * ra + 0.1 * batch` (layers.py:129-137), unlike
  `torch.nn.BatchNorm2d`. The apply follows layers.py:140-164 branch for
  branch: with an `act` or a `residual`, the folded
  `x * inv + (bias - mean * inv)` through the bn_act kernel
  (ops/cuda/bn_act.py); otherwise the unfused `(x - mean) * inv + bias`.
- `padding="SAME"` follows XLA's rule, which pads the high side more
  when the total is odd; PyTorch's symmetric `padding=` cannot express
  that, so asymmetric pads go through `F.pad`: zeros for convolutions
  and `avg_pool` (which, as flax's, counts the padded zeros), -inf for
  `max_pool`.
- Weights are drawn as flax draws them (`variance_scaling_`): a normal
  truncated at two standard deviations, with variance scale / fan, where
  a grouped kernel's fan_in is kh * kw * C_in / groups.
- `Dropout` draws its mask from the `torch.Generator` the caller sets as
  its `generator` (the Trainer derives one a step), as flax's draws from
  an explicit `dropout` rng. It computes flax's
  `where(uniform < keep, x / keep, 0)`. Masks put in its `replay` list
  are used instead, one a call, in call order.
- `ConvTranspose` is flax's (`transpose_kernel=False`): the HWIO kernel,
  not flipped, correlated with the input dilated by the stride, padded
  by lax's conv-transpose rule (SAME: k 5 s 2 -> (3, 2), k 3 s 2 ->
  (2, 1), k 5 s 1 -> (2, 2)). `F.conv_transpose2d` flips its kernel and
  pads symmetrically; the layer hands it the flipped, in/out-swapped
  kernel with padding `k - 1 - lo` and crops the extra trailing rows.
- `dtype` follows flax's `Conv`: input and kernel are cast to `dtype`
  (default: the promotion of the two), so f32 master weights get their
  gradients through the cast. No autocast.

The convolution itself stays `F.conv2d`, grouped and depthwise ones
included (`groups=`): the JAX package leaves convolutions to XLA, not to
a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
from deep_vision_tpu_torch.ops.cuda.norm import batch_moments, layer_norm

Padding = Union[str, Sequence[Tuple[int, int]]]
#: profiler range around a training BatchNorm's batch statistics
#: (tools/profile_train.py attributes its kernels to them)
BN_STATS_RANGE = "dvt::bn_stats"
#: profiler range around a LayerNorm
LAYERNORM_RANGE = "dvt::layernorm"


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME rule for one spatial dim -> (low, high) pad."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    """An int or an (h, w) pair -> (h, w)."""
    if isinstance(v, int):
        return v, v
    h, w = v
    return int(h), int(w)


def window_pads(x: torch.Tensor, kernel: Tuple[int, int],
                strides: Tuple[int, int], padding: Padding
                ) -> Tuple[Tuple[int, int], ...]:
    """flax's padding of an NCHW-indexed input: "SAME" (XLA's rule per
    spatial dim), "VALID", or explicit `[(lo, hi), (lo, hi)]`."""
    if padding == "SAME":
        return tuple(same_padding(s, k, st) for s, k, st in
                     zip(x.shape[2:], kernel, strides))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(tuple(p) for p in padding)


#: flax initializers by name: (scale, fan mode) of variance_scaling with a
#: truncated normal
INITIALIZERS = {"he_normal": (2.0, "fan_in"),
                "lecun_normal": (1.0, "fan_in"),
                "xavier_normal": (1.0, "fan_avg")}
#: flax `normal(stddev)` initializers by name: an untruncated normal (the
#: GANs' `normal(0.02)`, DCGAN's and CycleGAN's papers)
NORMAL_INITIALIZERS = {"normal_0.02": 0.02}


def variance_scaling_(w: torch.Tensor, scale: float, mode: str,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `variance_scaling(scale, mode, "truncated_normal")` for an
    OIHW conv weight (O, I / groups, kh, kw) or an (out, in) dense weight:
    a normal cut at two standard deviations, widened so the cut
    distribution keeps variance scale / fan. fan_in = I / groups * kh *
    kw (in), fan_out = O * kh * kw (out), fan_avg their mean."""
    fan_in = w[0].numel()
    fan_out = w.shape[0] * w[0, 0].numel()
    fan = {"fan_in": fan_in, "fan_out": fan_out,
           "fan_avg": (fan_in + fan_out) / 2}[mode]
    std = math.sqrt(scale / fan) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def init_kernel_(w: torch.Tensor, kernel_init: str,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Draw a kernel by its initializer's name: NORMAL_INITIALIZERS or
    INITIALIZERS (`variance_scaling_`)."""
    if kernel_init in NORMAL_INITIALIZERS:
        return nn.init.normal_(w, 0.0, NORMAL_INITIALIZERS[kernel_init],
                               generator=generator)
    return variance_scaling_(w, *INITIALIZERS[kernel_init], generator)


def trunc_normal_fan_in_(w: torch.Tensor, scale: float,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `variance_scaling(scale, "fan_in", "truncated_normal")`."""
    return variance_scaling_(w, scale, "fan_in", generator)


def flax_cast(x: torch.Tensor, w: torch.Tensor,
              dtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, ...]:
    """flax's `promote_dtype` for a layer: input and kernel in `dtype`,
    or in the promotion of their dtypes when it is None."""
    dt = dtype or torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           strides: Union[int, Tuple[int, int]],
           pads: Sequence[Tuple[int, int]], groups: int = 1) -> torch.Tensor:
    """`F.conv2d` with per-side (H, W) pads; asymmetric ones via F.pad."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    if h_lo == h_hi and w_lo == w_hi:
        return F.conv2d(x, w, stride=strides, padding=(h_lo, w_lo),
                        groups=groups)
    return F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), w, stride=strides,
                    groups=groups)


def _pool(x: torch.Tensor, window, strides, padding: Padding, fill: float,
          pool: Callable, implicit: bool) -> torch.Tensor:
    """`pool` over x with flax's padding: the pool's own symmetric
    padding where `implicit` allows and the pads are symmetric, else
    F.pad with `fill`."""
    window = pair(window)
    strides = pair(strides) if strides is not None else (1, 1)
    (h_lo, h_hi), (w_lo, w_hi) = window_pads(x, window, strides, padding)
    if (implicit and h_lo == h_hi and w_lo == w_hi
            and 2 * h_lo <= window[0] and 2 * w_lo <= window[1]):
        return pool(x, window, strides, padding=(h_lo, w_lo))
    if h_lo or h_hi or w_lo or w_hi:
        x = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=fill)
    return pool(x, window, strides)


def max_pool(x: torch.Tensor, window, strides=None,
             padding: Padding = "VALID") -> torch.Tensor:
    """flax `nn.max_pool` over NCHW-indexed x: strides default to 1, the
    padding (`window_pads`) holds -inf."""
    return _pool(x, window, strides, padding, float("-inf"), F.max_pool2d,
                 implicit=True)


def avg_pool(x: torch.Tensor, window, strides=None,
             padding: Padding = "VALID") -> torch.Tensor:
    """flax `nn.avg_pool` over NCHW-indexed x: the window's sum over its
    size, padded zeros included (flax's `count_include_pad`). The zeros
    are always padded with F.pad, never by `F.avg_pool2d(padding=)`: on
    the card (torch 2.11+cu128) that pool's backward gives wrong input
    gradients for a channels_last input with padding (3x3/1, pad 1:
    errors of the gradients' own size; tests/test_torch_cuda_kernels.py
    holds the port's pool there)."""
    return _pool(x, window, strides, padding, 0.0, F.avg_pool2d,
                 implicit=False)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W * C) in the reference's NHWC order, so a
    bridged Dense kernel (H * W * C, out) keeps its row order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet's channel shuffle (reference layers.py:41-52) on an
    NCHW-indexed tensor: channel `i * (C / g) + j` moves to `j * g + i`.
    Done on the NHWC view, so the result is channels_last."""
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    y = (x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups)
         .transpose(3, 4).reshape(b, h, w, c))
    return y.permute(0, 3, 1, 2)


class LocalResponseNorm(nn.Module):
    """AlexNet V1's LRN (reference layers.py:54-73): `x / (k + alpha *
    sum_window x^2)^beta` over `size` neighbouring channels, zeros past
    the ends. Unlike `torch.nn.LocalResponseNorm`, alpha is not divided
    by the window size."""

    def __init__(self, size: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, k: float = 2.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half, c = self.size // 2, x.shape[1]
        padded = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
        window = sum(padded[:, i:i + c] for i in range(self.size))
        return x / torch.pow(self.k + self.alpha * window, self.beta)


class Dropout(nn.Module):
    """flax `nn.Dropout`: in training mode, each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed; the
    mask is `uniform < 1 - rate`, drawn from `self.generator` (None: torch's
    default generator of x's device). Identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        #: boolean keep masks of x's shape to take, in call order, instead
        #: of drawing (a replayed step: the same masks on two devices)
        self.replay: List[torch.Tensor] = []

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        if self.replay:
            mask = self.replay.pop(0).to(x.device)
        else:
            mask = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class Conv(nn.Module):
    """flax `nn.Conv` over NCHW-indexed input: `weight` (features,
    in_features / groups, kh, kw) and, with `use_bias`, `bias`
    (features,), added after the convolution in its dtype. `kernel` and
    `strides` are ints or (h, w) pairs; `padding` as `window_pads`;
    `groups` is flax's feature_group_count; `kernel_init` names an
    INITIALIZERS or NORMAL_INITIALIZERS entry (flax's default:
    lecun_normal); `bias_init` is the bias's constant initial value;
    `dtype` as `flax_cast`."""

    def __init__(self, in_features: int, features: int,
                 kernel: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Padding = "SAME", groups: int = 1,
                 use_bias: bool = True, kernel_init: str = "lecun_normal",
                 dtype: Optional[torch.dtype] = None,
                 bias_init: float = 0.0):
        super().__init__()
        if in_features % groups or features % groups:
            raise ValueError(f"{in_features} -> {features} channels do not "
                             f"split into {groups} groups")
        self.kernel = pair(kernel)
        self.strides = pair(strides)
        self.padding = padding
        self.groups = groups
        self.kernel_init = kernel_init
        self.bias_init = float(bias_init)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, *self.kernel))
        self.bias = (nn.Parameter(torch.full((features,), self.bias_init))
                     if use_bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            init_kernel_(self.weight, self.kernel_init, generator)
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = flax_cast(x, self.weight, self.dtype)
        y = conv2d(x, w, self.strides,
                   window_pads(x, self.kernel, self.strides, self.padding),
                   self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return y


def conv_transpose_same_padding(kernel: int,
                                stride: int) -> Tuple[int, int]:
    """lax's SAME padding (lo, hi) of the stride-dilated input for a flax
    ConvTranspose, one spatial dim."""
    pad_len = kernel + stride - 2
    lo = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return lo, pad_len - lo


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose` (transpose_kernel=False, padding "SAME",
    the models' only) over NCHW-indexed input: the output is the
    correlation of the input, dilated by `strides` and padded by
    `conv_transpose_same_padding`, with the kernel as it is; in x stride
    outputs a dim. `weight` is (features, in_features, kh, kw), flax's
    HWIO kernel permuted as a Conv's (convert.py maps both alike),
    unflipped; `bias` (features,) with `use_bias`. The output is
    channels_last."""

    def __init__(self, in_features: int, features: int,
                 kernel: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1,
                 use_bias: bool = True, kernel_init: str = "lecun_normal"):
        super().__init__()
        self.kernel = pair(kernel)
        self.strides = pair(strides)
        self.pads = tuple(conv_transpose_same_padding(k, s)
                          for k, s in zip(self.kernel, self.strides))
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               *self.kernel))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            init_kernel_(self.weight, self.kernel_init, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # out[y] = sum_t x[j] K[t] where y = j s + lo - t; conv_transpose2d
        # sums over y = j s - p + t', so t' = k - 1 - t (the flip) and
        # p = k - 1 - lo; its output is lo - hi longer than lax's (crop)
        # or hi - lo shorter (output_padding, below the stride)
        w = self.weight.transpose(0, 1).flip(2, 3)
        (lo_h, hi_h), (lo_w, hi_w) = self.pads
        y = F.conv_transpose2d(
            x, w, self.bias, stride=self.strides,
            padding=(self.kernel[0] - 1 - lo_h, self.kernel[1] - 1 - lo_w),
            output_padding=(max(hi_h - lo_h, 0), max(hi_w - lo_w, 0)))
        h = y.shape[2] - max(lo_h - hi_h, 0)
        w_ = y.shape[3] - max(lo_w - hi_w, 0)
        return y[:, :, :h, :w_].contiguous(memory_format=torch.channels_last)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`jnp.pad(mode="reflect")` of H and W by `pad` (edge not repeated)
    on NCHW-indexed x, channels_last out."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect").contiguous(
        memory_format=torch.channels_last)


def instance_norm(x: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel `(x - mean) / sqrt(var + eps)` over H and
    W, the population variance `mean((x - mean)^2)`, as jnp.mean and
    jnp.var compute them (CycleGAN's `_Norm`, models/cyclegan.py:24-37
    of the reference)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = torch.square(x - mean).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + epsilon)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x of H and W: output pixel (i, j) reads (i // 2, j // 2),
    `jnp.repeat` twice (models/hourglass.py:70 of the reference)."""
    return F.interpolate(x, scale_factor=2, mode="nearest").contiguous(
        memory_format=torch.channels_last)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW with the reference's f32 arithmetic.

    Training mode normalises with the batch statistics and updates the
    running ones in place; eval mode uses the running ones. `act`
    ("relu" or None) and a `residual` call argument fold into the apply,
    which then runs through the bn_act kernel. The output has x's dtype.
    `scale_init` is the initial scale (0 for a bottleneck's tail)."""

    #: the running statistics keep 90% of their value a step (the
    #: reference's momentum, the same for every BatchNorm it has)
    MOMENTUM = 0.9

    def __init__(self, features: int, epsilon: float = 1e-5,
                 act: Optional[str] = None, scale_init: float = 1.0):
        super().__init__()
        if act not in ("relu", None):
            raise ValueError(f"unsupported act {act!r}")
        self.epsilon = epsilon
        self.act = act
        self.scale_init = scale_init
        self.scale = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(self.scale_init)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def _batch_stats(self, x: torch.Tensor):
        """f32 E[x] and max(E[x^2] - E[x]^2, 0) over all axes but C; the
        running statistics move 10% of the way to them. E[x] and E[x^2]
        come from one pass over x (ops/cuda/norm.py `batch_moments`);
        the rest is (C,)-sized."""
        with torch.profiler.record_function(BN_STATS_RANGE):
            mean, mean2 = batch_moments(x)
            var = torch.clamp_min(mean2 - torch.square(mean), 0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.mean, self.var
        inv = self.scale * torch.rsqrt(var + self.epsilon)
        if self.act is not None or residual is not None:
            return fused_scale_bias_act(x, inv, self.bias - mean * inv,
                                        residual=residual, act=self.act)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = ((x.float() - mean.view(shape)) * inv.view(shape)
             + self.bias.view(shape))
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv + BatchNorm + activation, NCHW (reference layers.py:173-217).

    `kernel`/`strides` are ints or (h, w) pairs; `padding` is "SAME"
    (XLA's rule, computed per call from the input size), "VALID" or
    explicit `[(lo, hi), (lo, hi)]` for (H, W); `groups` is flax's
    feature_group_count. With `use_bn`, `act=F.relu` folds into the
    BatchNorm (the bn_act kernel), with the `residual` call argument if
    one is given, and any other `act` runs after it. Without it the conv
    carries a bias (flax's `use_bias or not use_bn`), and the residual
    and `act` follow it. `kernel_init` names the conv's INITIALIZERS
    entry (he_normal, the reference's default). `dtype` is the conv's
    (flax semantics, see `flax_cast`); the BatchNorm keeps the conv
    output's dtype."""

    def __init__(self, in_features: int, features: int,
                 kernel: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Padding = "SAME", groups: int = 1,
                 use_bn: bool = True, use_bias: bool = False,
                 act: Optional[Callable] = F.relu,
                 kernel_init: str = "he_normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_bn = use_bn
        fuse_relu = use_bn and act is F.relu
        self.act = None if fuse_relu else act
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           groups, use_bias=use_bias or not use_bn,
                           kernel_init=kernel_init, dtype=dtype)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(features,
                                         act="relu" if fuse_relu else None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.Conv_0.reset_parameters(generator)
        if self.use_bn:
            self.BatchNorm_0.reset_parameters()

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.use_bn:
            x = self.BatchNorm_0(x, residual=residual)
        elif residual is not None:
            x = x + residual
        return self.act(x) if self.act is not None else x


class DepthwiseSeparableConv(nn.Module):
    """MobileNet's depthwise 3x3 ConvBN (groups = in_features) and
    pointwise 1x1 ConvBN (reference layers.py:220-245)."""

    def __init__(self, in_features: int, features: int,
                 strides: Union[int, Tuple[int, int]] = 1,
                 act: Optional[Callable] = F.relu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, in_features, 3, strides,
                               groups=in_features, act=act, dtype=dtype)
        self.ConvBN_1 = ConvBN(in_features, features, 1, act=act,
                               dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBN_1(self.ConvBN_0(x))


class LayerNorm(nn.Module):
    """flax `LayerNorm` over the last axis, as the ViT uses it: epsilon
    1e-6 (torch's default is 1e-5); statistics in at least float32 with
    the fast variance `max(E[x^2] - E[x]^2, 0)`; `(x - mean) * (rsqrt(var
    + eps) * scale) + bias` in float32, returned in `dtype` (default: the
    promotion of x's dtype and float32), or in the call's `out_dtype`,
    which rounds the float32 result once, as a cast of the `dtype` output
    would. One pass over x, forward and backward (ops/cuda/norm.py
    `layer_norm`). `scale` and `bias` keep the flax names.
    `LAYERNORM_RANGE` marks its work for the profiler."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = out_dtype or self.dtype or torch.promote_types(x.dtype,
                                                            torch.float32)
        with torch.profiler.record_function(LAYERNORM_RANGE):
            return layer_norm(x, self.scale, self.bias, self.epsilon, dt)


class DenseGeneral(nn.Module):
    """flax `Dense` / `DenseGeneral` over the last len(in_shape) axes:
    `(..., *in_shape) -> (..., *features)`. The kernel is kept as one 2-D
    (prod(features), prod(in_shape)) `weight`, as `F.linear` takes it
    (convert.py flattens flax's (*in_shape, *features) kernel into it),
    and the bias, unless `use_bias` is False, as (prod(features),). As
    `flax_cast` does, input and
    kernel are cast to `dtype` (default: their promotion), and the bias
    is added after the product, in the product's dtype, as flax adds
    it. `kernel_init` names an INITIALIZERS entry (flax's default:
    lecun_normal), over the flattened fans, or a NORMAL_INITIALIZERS
    one."""

    def __init__(self, in_shape: Union[int, Sequence[int]],
                 features: Union[int, Sequence[int]],
                 dtype: Optional[torch.dtype] = None,
                 kernel_init: str = "lecun_normal", use_bias: bool = True):
        super().__init__()
        self.kernel_init = kernel_init
        self.in_shape = ((in_shape,) if isinstance(in_shape, int)
                         else tuple(in_shape))
        self.features = ((features,) if isinstance(features, int)
                         else tuple(features))
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(math.prod(self.features),
                                               math.prod(self.in_shape)))
        self.bias = (nn.Parameter(torch.zeros(math.prod(self.features)))
                     if use_bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """`kernel_init` over the flattened fans, zero bias."""
        with torch.no_grad():
            init_kernel_(self.weight, self.kernel_init, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        x, w = flax_cast(x.reshape(*lead, -1), self.weight, self.dtype)
        y = F.linear(x, w)
        if self.bias is not None:
            y = y + self.bias.to(w.dtype)
        return y.reshape(*lead, *self.features)


def Dense(in_features: int, features: int,
          dtype: Optional[torch.dtype] = None,
          kernel_init: str = "lecun_normal",
          use_bias: bool = True) -> DenseGeneral:
    """flax `nn.Dense`: a DenseGeneral over the last axis."""
    return DenseGeneral(in_features, features, dtype=dtype,
                        kernel_init=kernel_init, use_bias=use_bias)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC mean over H and W, summed in f32 and rounded to x's
    dtype, as `jnp.mean` does for bf16."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)


def calibrate_batch_stats(model: nn.Module, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    its input on `images`, layer by layer in one forward pass. A randomly
    initialized Darknet keeps activations of order 1 this way, as a
    trained one does; with init statistics (mean 0, var 1) its 23 residual
    adds grow them until every output sigmoid saturates."""
    def hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for h in handles:
            h.remove()


def reset_flax_parameters(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Draw every weight of `model` as flax initializes it, in module
    order from `generator`: each Conv, ConvTranspose and Dense by its
    `kernel_init`
    with a zero bias, each BatchNorm at its init (running statistics 0 /
    1). Then the 4-D weights go to channels_last memory, so cuDNN's NHWC
    convolutions keep the activations channels_last end to end."""
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose, DenseGeneral)):
            m.reset_parameters(generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    model.to(memory_format=torch.channels_last)
