"""Stacked Hourglass for pose estimation, the port of
deep_vision_tpu/models/hourglass.py (:20-115).

NHWC images (B, 256, 256, 3) in, a list of per-stack NHWC heatmaps
(B, 64, 64, K) out. `HgBottleneck` is pre-activation: each of its three
BatchNorms runs without an activation and a separate ReLU follows, as
in the reference (no fold into bn_act: a fold changes the numbers), so
every BatchNorm's batch statistics go through the moments kernels and
its apply stays unfused. `HourglassModule` recurses down by 2x2 max
pools and back up by nearest 2x upsampling. Modules are created in the
reference's call order, so their flax auto-names (`HgBottleneck_2`,
`HourglassModule_0`, `Conv_4`, ...) match its variable tree. Kernels are
flax's default lecun_normal, biases 0. Every BatchNorm input is
channels_last: the permuted NHWC input is, convolutions keep it, and
`upsample_nearest2x` returns it.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    max_pool,
    reset_flax_parameters,
    upsample_nearest2x,
)


class Named(nn.Module):
    """A module whose children are added under flax auto-names:
    `add(module)` names it `<ClassName>_<n>`, n counting that class.
    Subclasses keep their own references to the children in plain lists
    and tuples, which nn.Module does not register a second time."""

    def add(self, module: nn.Module) -> nn.Module:
        counts = self.__dict__.setdefault("_flax_counts", {})
        kind = type(module).__name__
        n = counts.get(kind, 0)
        counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", module)
        return module


class HgBottleneck(Named):
    """BN-ReLU-1x1 (features/2), BN-ReLU-3x3, BN-ReLU-1x1 (features), plus
    the input, through a 1x1 projection where the width changes."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        half = features // 2
        self.bns = [self.add(BatchNorm(c)) for c in (in_features, half, half)]
        self.convs = [self.add(Conv(i, o, k, use_bias=False)) for i, o, k in
                      ((in_features, half, 1), (half, half, 3),
                       (half, features, 1))]
        self.project = ([self.add(Conv(in_features, features, 1,
                                       use_bias=False))]
                        if in_features != features else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for bn, conv in zip(self.bns, self.convs):
            y = conv(F.relu(bn(y)))
        return y + (self.project[0](x) if self.project else x)


class HourglassModule(Named):
    """Recursive down-up module of `order` levels at `features` wide."""

    def __init__(self, order: int, features: int = 256,
                 num_residual: int = 1):
        super().__init__()
        f, r = features, num_residual
        self.up = [self.add(HgBottleneck(f, f)) for _ in range(r)]
        self.down = [self.add(HgBottleneck(f, f)) for _ in range(r)]
        self.inner = ([self.add(HourglassModule(order - 1, f, r))]
                      if order > 1 else
                      [self.add(HgBottleneck(f, f)) for _ in range(r)])
        self.back = [self.add(HgBottleneck(f, f)) for _ in range(r)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = x
        for m in self.up:
            up = m(up)
        low = max_pool(x, 2, 2)
        for m in self.down + self.inner + self.back:
            low = m(low)
        return up + upsample_nearest2x(low)


class StackedHourglass(Named):
    """NHWC images -> [(B, H/4, W/4, num_heatmap)] * num_stack."""

    def __init__(self, num_stack: int = 4, num_heatmap: int = 16,
                 features: int = 256, num_residual: int = 1,
                 in_features: int = 3):
        super().__init__()
        f = features
        self.num_stack = num_stack
        self.stem = (self.add(Conv(in_features, 64, 7, 2, use_bias=False)),
                     self.add(BatchNorm(64)),
                     self.add(HgBottleneck(64, 128)),
                     self.add(HgBottleneck(128, 128)),
                     self.add(HgBottleneck(128, f)))
        self.stacks = []
        for stack in range(num_stack):
            parts = [self.add(HourglassModule(4, f, num_residual)),
                     self.add(HgBottleneck(f, f)),
                     self.add(Conv(f, f, 1, use_bias=False)),
                     self.add(BatchNorm(f)),
                     self.add(Conv(f, num_heatmap, 1))]
            if stack < num_stack - 1:
                parts += [self.add(Conv(f, f, 1, use_bias=False)),
                          self.add(Conv(num_heatmap, f, 1, use_bias=False))]
            self.stacks.append(parts)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        conv, bn, first, second, third = self.stem
        x = F.relu(bn(conv(images.permute(0, 3, 1, 2))))
        x = third(second(max_pool(first(x), 2, 2)))
        heatmaps = []
        for hg, bottleneck, conv, bn, head, *merge in self.stacks:
            inter = F.relu(bn(conv(bottleneck(hg(x)))))
            hm = head(inter)
            heatmaps.append(hm.permute(0, 2, 3, 1))
            if merge:
                x = x + merge[0](inter) + merge[1](hm)
        return heatmaps


@register_model("hourglass", init=reset_flax_parameters)
def hourglass(num_stack: int = 4, num_heatmap: int = 16, **_):
    return StackedHourglass(num_stack=num_stack, num_heatmap=num_heatmap)
