"""ResNet-34/50/152 and ResNet-50 V2 (pre-activation), the port of
deep_vision_tpu/models/resnet.py.

Public layout matches the JAX model: NHWC images in (`(B, H, W, 3)` for
the conv7 stem, space-to-depth `(B, H/2, W/2, 12)` for the s2d stem),
logits `(B, num_classes)` out. Inside, tensors are NCHW-indexed and live
in channels_last memory end to end: the permuted NHWC input already is
such a view, `get_model` stores the conv weights channels_last, and
cuDNN's NHWC convolutions then need no layout transposes.

Submodules carry the flax auto-names (`SpaceToDepthStem_0`,
`BatchNorm_0`, `BottleneckBlock_3`, `ConvBN_1`, `Conv_0`, `Dense_0`,
...), so state_dict keys are the reference's variable paths
(convert.py). Every BatchNorm with a ReLU or a residual (two ConvBNs and
the tail of each bottleneck) runs through the bn_act kernel; the s2d
stem's BatchNorm and the projection ConvBNs have no act and stay unfused,
as in the reference. `resnet50v2` (`preact`, reference :77-99 and
:159-181) runs BatchNorm-ReLU-conv blocks: a plain 7x7/2 conv stem, each
block's pre-activation and middle BatchNorms unfused with a separate
ReLU (as the reference applies them), its 3x3 ConvBN through bn_act (16
a step), the skip a plain add, and a final BatchNorm and ReLU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvBN,
    conv2d,
    flax_cast,
    global_avg_pool,
    trunc_normal_fan_in_,
)


def reset_parameters(model: nn.Module,
                     generator: Optional[torch.Generator]) -> None:
    """Draw every weight as flax initializes it, in module order from
    `generator`: ConvBN convs and the stem he-normal, the bottleneck's bare
    1x1 conv and the Dense kernel lecun-normal (flax's Conv/Dense default),
    Dense bias 0, BatchNorm scale at its init (0 for a bottleneck's tail)
    and bias 0, running stats 0 / 1; the pre-activation blocks' and the
    preact stem's bare convs lecun-normal. Then the 4-D weights go to
    channels_last memory."""
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.reset_parameters(generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()  # the ConvBNs' own are reset twice: harmless
        elif isinstance(m, SpaceToDepthStem):
            with torch.no_grad():
                trunc_normal_fan_in_(m.weight, 2.0, generator)
        elif isinstance(m, BottleneckBlock):
            with torch.no_grad():
                trunc_normal_fan_in_(m.Conv_0.weight, 1.0, generator)
        elif isinstance(m, PreActBottleneckBlock):
            for conv in m.children():
                if isinstance(conv, Conv):
                    conv.reset_parameters(generator)
        elif isinstance(m, ResNet):
            if hasattr(m, "Conv_0"):  # the preact conv7 stem
                m.Conv_0.reset_parameters(generator)
            with torch.no_grad():
                trunc_normal_fan_in_(m.Dense_0.weight, 1.0, generator)
                m.Dense_0.bias.zero_()
    model.to(memory_format=torch.channels_last)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, 3, strides, dtype=dtype)
        # the tail (BN + skip-add + ReLU in one kernel pass); constructed
        # before the projection, as flax names it ConvBN_1
        self.ConvBN_1 = ConvBN(features, features, 3, dtype=dtype)
        if in_features != features or strides != 1:
            self.ConvBN_2 = ConvBN(in_features, features, 1, strides,
                                   act=None, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.ConvBN_0(x)
        if hasattr(self, "ConvBN_2"):
            residual = self.ConvBN_2(x)
        return self.ConvBN_1(y, residual=residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 at 4x width; the tail BatchNorm (scale
    initialised to 0, so each block starts as the identity) applies, adds
    the skip tensor and takes the ReLU in one bn_act pass."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(in_features, features, 1, dtype=dtype)
        self.ConvBN_1 = ConvBN(features, features, 3, strides, dtype=dtype)
        self.Conv_0 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features * 4, act="relu", scale_init=0.0)
        if in_features != features * 4 or strides != 1:
            self.ConvBN_2 = ConvBN(in_features, features * 4, 1, strides,
                                   act=None, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.ConvBN_1(self.ConvBN_0(x))
        y, w = flax_cast(y, self.Conv_0.weight, self.dtype)
        y = F.conv2d(y, w)
        if hasattr(self, "ConvBN_2"):
            residual = self.ConvBN_2(x)
        return self.BatchNorm_0(y, residual=residual)


class PreActBottleneckBlock(nn.Module):
    """BatchNorm-ReLU, then 1x1 -> 3x3 (strided ConvBN) -> BatchNorm-ReLU
    -> 1x1 at 4x width, plus the skip: x, or a strided 1x1 conv of the
    pre-activation. The flax names follow construction order: the
    projection, when there is one, is Conv_0."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_features)
        self.needs_proj = in_features != features * 4 or strides != 1
        convs = [(in_features, features, 1, 1)]
        if self.needs_proj:
            convs.insert(0, (in_features, features * 4, 1, strides))
        convs.append((features, features * 4, 1, 1))
        for k, (cin, cout, kernel, s) in enumerate(convs):
            setattr(self, f"Conv_{k}", Conv(cin, cout, kernel, s,
                                            use_bias=False, dtype=dtype))
        self.ConvBN_0 = ConvBN(features, features, 3, strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.BatchNorm_0(x))
        k = int(self.needs_proj)
        residual = self.Conv_0(pre) if self.needs_proj else x
        y = self.ConvBN_0(getattr(self, f"Conv_{k}")(pre))
        y = getattr(self, f"Conv_{k + 1}")(F.relu(self.BatchNorm_1(y)))
        return y + residual


class SpaceToDepthStem(nn.Module):
    """The 7x7/s2 stem conv on space-to-depth input, as a 4x4/s1 conv over
    12 channels. The parameter keeps the canonical 7x7 shape, OIHW
    `(features, 3, 7, 7)`; each call pads it to 8x8 at the top-left and
    reshuffles it into `(features, 12, 4, 4)` (resnet.py:132-137), with
    input channel `(dy * 2 + dx) * 3 + c`. The conv pads (2, 1) on each
    spatial axis. Compute dtype: `dtype`, else the input's."""

    def __init__(self, features: int = 64, in_features: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 7, 7))

    def kernel(self) -> torch.Tensor:
        o, c = self.weight.shape[:2]
        k8 = F.pad(self.weight, (1, 0, 1, 0))  # (O, C, 8, 8)
        return (k8.reshape(o, c, 4, 2, 4, 2)  # o, c, i, dy, j, dx
                .permute(0, 3, 5, 1, 2, 4)    # o, dy, dx, c, i, j
                .reshape(o, 4 * c, 4, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return conv2d(x.to(dt), self.kernel().to(dt), 1, ((2, 1), (2, 1)))


class ResNet(nn.Module):
    """NHWC images -> logits. `stem`: "conv7" (7x7/s2 ConvBN on (H, W, 3))
    or "s2d" (SpaceToDepthStem on (H/2, W/2, 12), then an unfused BN and
    a ReLU). With `preact` the conv7 stem is a plain conv, the s2d stem
    has no BatchNorm, and a BatchNorm and a ReLU follow the last block.
    `dtype` is the convolutions' compute dtype; the classifier runs in
    f32 over the pooled features."""

    def __init__(self, stage_sizes: Sequence[int],
                 block: type = BottleneckBlock,
                 num_classes: int = 1000, width: int = 64, stem: str = "conv7",
                 dtype: Optional[torch.dtype] = None, preact: bool = False):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r} (conv7 or s2d)")
        self.stem = stem
        self.preact = preact
        self.stage_sizes = tuple(stage_sizes)
        if stem == "s2d":
            self.SpaceToDepthStem_0 = SpaceToDepthStem(64, dtype=dtype)
            if not preact:
                self.BatchNorm_0 = BatchNorm(64)
        elif preact:
            self.Conv_0 = Conv(3, 64, 7, 2, [(3, 3), (3, 3)], use_bias=False,
                               dtype=dtype)
        else:
            self.ConvBN_0 = ConvBN(3, 64, 7, 2, padding=[(3, 3), (3, 3)],
                                   dtype=dtype)
        expansion = 1 if block is BasicBlock else 4
        prev, k = 64, 0
        for i, n_blocks in enumerate(self.stage_sizes):
            features = width * 2 ** i
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                setattr(self, f"{block.__name__}_{k}",
                        block(prev, features, strides, dtype=dtype))
                prev, k = features * expansion, k + 1
        self.num_blocks = k
        self.block_name = block.__name__
        if preact:
            self.BatchNorm_0 = BatchNorm(prev)
        self.Dense_0 = nn.Linear(prev, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        if self.stem == "s2d":
            x = self.SpaceToDepthStem_0(x)
            if not self.preact:
                x = F.relu(self.BatchNorm_0(x))
        elif self.preact:
            x = self.Conv_0(x)
        else:
            x = self.ConvBN_0(x)
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # -inf padding
        for k in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{k}")(x)
        if self.preact:
            x = F.relu(self.BatchNorm_0(x))
        x, w = flax_cast(global_avg_pool(x), self.Dense_0.weight,
                         torch.float32)
        return F.linear(x, w, self.Dense_0.bias)


@register_model("resnet34", init=reset_parameters)
def resnet34(num_classes: int = 1000, dtype=None, stem: str = "conv7", **_):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BasicBlock,
                  num_classes=num_classes, stem=stem, dtype=dtype)


@register_model("resnet50", init=reset_parameters)
def resnet50(num_classes: int = 1000, dtype=None, stem: str = "conv7", **_):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BottleneckBlock,
                  num_classes=num_classes, stem=stem, dtype=dtype)


@register_model("resnet152", init=reset_parameters)
def resnet152(num_classes: int = 1000, dtype=None, stem: str = "conv7", **_):
    return ResNet(stage_sizes=(3, 8, 36, 3), block=BottleneckBlock,
                  num_classes=num_classes, stem=stem, dtype=dtype)


@register_model("resnet50v2", init=reset_parameters)
def resnet50v2(num_classes: int = 1000, dtype=None, stem: str = "conv7",
               **_):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=PreActBottleneckBlock,
                  num_classes=num_classes, stem=stem, dtype=dtype,
                  preact=True)
