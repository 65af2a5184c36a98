"""ConvBN and BatchNorm, the port of deep_vision_tpu/nn/layers.py, and
the flax layers the ViT uses (LayerNorm, Dense, DenseGeneral).

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
  that, so asymmetric pads go through `F.pad`.
- `dtype` follows flax's `Conv`: input and kernel are cast to `dtype`
  (default: the promotion of the two), so f32 master weights get their
  gradients through the cast. No autocast.

The convolution itself stays `F.conv2d`: the JAX package leaves
convolutions to XLA, not to a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

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


def trunc_normal_fan_in_(w: torch.Tensor, scale: float,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `variance_scaling(scale, "fan_in", "truncated_normal")` for an
    OIHW conv weight or an (out, in) dense weight: a normal cut at two
    standard deviations, widened so the cut distribution keeps variance
    scale / fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def flax_cast(x: torch.Tensor, w: torch.Tensor,
              dtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, ...]:
    """flax's `promote_dtype` for a layer: input and kernel in `dtype`,
    or in the promotion of their dtypes when it is None."""
    dt = dtype or torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def conv2d(x: torch.Tensor, w: torch.Tensor, strides: int,
           pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`F.conv2d` with per-side (H, W) pads; asymmetric ones via F.pad."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    if h_lo == h_hi and w_lo == w_hi:
        return F.conv2d(x, w, stride=strides, padding=(h_lo, w_lo))
    return F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), w, stride=strides)


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
    """Conv (no bias) + BatchNorm + activation, NCHW.

    `kernel`/`strides` are square ints; `padding` is "SAME" (XLA's rule,
    computed per call from the input size) or explicit
    `[(lo, hi), (lo, hi)]` for (H, W). `act=F.relu` folds into the
    BatchNorm (the bn_act kernel), with the `residual` call argument if
    one is given; any other `act` runs after it. `dtype` is the conv's
    (flax semantics, see `flax_cast`); the BatchNorm keeps the conv
    output's dtype."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, padding: Padding = "SAME",
                 act: Optional[Callable] = F.relu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = int(kernel)
        self.strides = int(strides)
        self.padding = padding
        fuse_relu = act is F.relu
        self.act = None if fuse_relu else act
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, self.kernel,
                                stride=self.strides, bias=False)
        self.BatchNorm_0 = BatchNorm(features,
                                     act="relu" if fuse_relu else None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():  # he_normal, the ConvBN default
            trunc_normal_fan_in_(self.Conv_0.weight, 2.0, generator)
        self.BatchNorm_0.reset_parameters()

    def _pads(self, x: torch.Tensor) -> Tuple[Tuple[int, int], ...]:
        if self.padding == "SAME":
            return tuple(same_padding(s, self.kernel, self.strides)
                         for s in x.shape[2:])
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        x, w = flax_cast(x, self.Conv_0.weight, self.dtype)
        x = self.BatchNorm_0(conv2d(x, w, self.strides, self._pads(x)),
                             residual=residual)
        return self.act(x) if self.act is not None else x


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
    and the bias as (prod(features),). As `flax_cast` does, input and
    kernel are cast to `dtype` (default: their promotion), and the bias
    is added after the product, in the product's dtype, as flax adds
    it."""

    def __init__(self, in_shape: Union[int, Sequence[int]],
                 features: Union[int, Sequence[int]],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_shape = ((in_shape,) if isinstance(in_shape, int)
                         else tuple(in_shape))
        self.features = ((features,) if isinstance(features, int)
                         else tuple(features))
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(math.prod(self.features),
                                               math.prod(self.in_shape)))
        self.bias = nn.Parameter(torch.zeros(math.prod(self.features)))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """lecun_normal over the flattened fan-in, zero bias (flax's
        defaults)."""
        with torch.no_grad():
            trunc_normal_fan_in_(self.weight, 1.0, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        x, w = flax_cast(x.reshape(*lead, -1), self.weight, self.dtype)
        y = F.linear(x, w) + self.bias.to(w.dtype)
        return y.reshape(*lead, *self.features)


def Dense(in_features: int, features: int,
          dtype: Optional[torch.dtype] = None) -> DenseGeneral:
    """flax `nn.Dense`: a DenseGeneral over the last axis."""
    return DenseGeneral(in_features, features, dtype=dtype)


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
