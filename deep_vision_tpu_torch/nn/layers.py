"""ConvBN and BatchNorm, the eval path of deep_vision_tpu/nn/layers.py.

Layout: modules take and return NCHW tensors (PyTorch's convolution
layout); the models keep the JAX package's NHWC at their public edge.

Two places where the port must not follow PyTorch's habits:

- `BatchNorm` keeps the reference's arithmetic, in f32:
  `(x - mean) * (scale * rsqrt(var + eps)) + bias` (layers.py:138,163),
  with `scale`/`bias` as parameters and `mean`/`var` as buffers under the
  flax names, so bridged variables (convert.py) load one to one.
  `torch.nn.BatchNorm2d` folds the terms in another order.
- `padding="SAME"` follows XLA's rule, which pads the high side more
  when the total is odd; PyTorch's symmetric `padding=` cannot express
  that, so asymmetric pads go through `F.pad`.

Only the eval path (running statistics) exists: batch statistics and
their update arrive with the training slice, and a module left in
training mode raises instead of silently using running statistics.

The convolution itself stays `F.conv2d`: the JAX package leaves
convolutions to XLA, not to a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME rule for one spatial dim -> (low, high) pad."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def trunc_normal_fan_in_(w: torch.Tensor, scale: float,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `variance_scaling(scale, "fan_in", "truncated_normal")` for an
    OIHW conv weight: a normal cut at two standard deviations, widened so
    the cut distribution keeps variance scale / fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class BatchNorm(nn.Module):
    """Inference BatchNorm over NCHW with the reference's f32 arithmetic."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm has only the eval path (running statistics) so "
                "far; call .eval() on the model")
        inv = self.scale * torch.rsqrt(self.var + self.epsilon)
        y = ((x.float() - self.mean[:, None, None]) * inv[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + activation, NCHW.

    `kernel`/`strides` are square ints; `padding` is "SAME" (XLA's rule,
    computed per call from the input size) or explicit
    `[(lo, hi), (lo, hi)]` for (H, W)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, padding: Padding = "SAME",
                 act: Optional[Callable] = F.relu):
        super().__init__()
        self.kernel = int(kernel)
        self.strides = int(strides)
        self.padding = padding
        self.act = act
        self.Conv_0 = nn.Conv2d(in_features, features, self.kernel,
                                stride=self.strides, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():  # he_normal, the ConvBN default
            trunc_normal_fan_in_(self.Conv_0.weight, 2.0, generator)
        self.BatchNorm_0.reset_parameters()

    def _pads(self, x: torch.Tensor) -> Tuple[Tuple[int, int], ...]:
        if self.padding == "SAME":
            return tuple(same_padding(s, self.kernel, self.strides)
                         for s in x.shape[2:])
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h_lo, h_hi), (w_lo, w_hi) = self._pads(x)
        if h_lo == h_hi and w_lo == w_hi:
            x = F.conv2d(x, self.Conv_0.weight, stride=self.strides,
                         padding=(h_lo, w_lo))
        else:
            x = F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)),
                         self.Conv_0.weight, stride=self.strides)
        x = self.BatchNorm_0(x)
        return self.act(x) if self.act is not None else x


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
