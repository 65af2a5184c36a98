"""Darknet-53 backbone + YOLOv3 head, the port of deep_vision_tpu/models/yolov3.py.

Public layout matches the JAX model: NHWC images in, three raw scale
outputs `(B, g, g, 3, 5+C)` out (stride 32, 16, 8). Inside, tensors are
NCHW-indexed in channels_last memory: the NHWC input permuted, the
weights stored channels_last by `reset_parameters`, and the neck's
permutes, concatenations and upsampling keep that layout, so every
training BatchNorm hands the moments kernel the (rows, C) matrix it
reads. Darknet's ConvBN takes the unfused BatchNorm apply and then the
leaky ReLU, the reference's arithmetic. Submodule names are the flax auto-names (`Darknet53_0`,
`DarknetResidual_3`, `ConvBN_0`, `Conv_0`, ...), so the state_dict keys
are the reference's variable paths with '.' for '/' (convert.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import ConvBN, trunc_normal_fan_in_

#: (features, residual blocks) per stride-2 stage of Darknet-53
DARKNET53_STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator]) -> None:
    """Re-draw every weight as flax initializes it: ConvBN convs he-normal,
    BatchNorm scale 1 / bias 0 / mean 0 / var 1, the head's plain conv
    lecun-normal with a zero bias. Draws follow module order, from
    `generator`. Then the 4-D weights go to channels_last memory."""
    for m in module.modules():
        if isinstance(m, ConvBN):
            m.reset_parameters(generator)
        elif isinstance(m, YoloHead):
            with torch.no_grad():
                trunc_normal_fan_in_(m.Conv_0.weight, 1.0, generator)
                m.Conv_0.bias.zero_()
    module.to(memory_format=torch.channels_last)


class DarknetConv(nn.Module):
    """ConvBN with leaky 0.1; stride-2 convs pad top-left only
    (`[(1, 0), (1, 0)]`, yolov3.py:32)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1):
        super().__init__()
        pad = "SAME" if strides == 1 else [(1, 0), (1, 0)]
        self.ConvBN_0 = ConvBN(in_features, features, kernel, strides,
                               padding=pad, act=_leaky)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBN_0(x)


class DarknetResidual(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.DarknetConv_0 = DarknetConv(features, features // 2, 1)
        self.DarknetConv_1 = DarknetConv(features // 2, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.DarknetConv_1(self.DarknetConv_0(x))


class Darknet53(nn.Module):
    """Backbone: NHWC images -> NHWC (C3, C4, C5) at /8, /16, /32."""

    def __init__(self, in_features: int = 3):
        super().__init__()
        self.DarknetConv_0 = DarknetConv(in_features, 32, 3)
        prev, r = 32, 0
        for s, (feat, blocks) in enumerate(DARKNET53_STAGES):
            setattr(self, f"DarknetConv_{s + 1}",
                    DarknetConv(prev, feat, 3, strides=2))
            for _ in range(blocks):
                setattr(self, f"DarknetResidual_{r}", DarknetResidual(feat))
                r += 1
            prev = feat

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.DarknetConv_0(images.permute(0, 3, 1, 2))
        feats, r = [], 0
        for s, (_, blocks) in enumerate(DARKNET53_STAGES):
            x = getattr(self, f"DarknetConv_{s + 1}")(x)
            for _ in range(blocks):
                x = getattr(self, f"DarknetResidual_{r}")(x)
                r += 1
            feats.append(x)
        return tuple(f.permute(0, 2, 3, 1) for f in feats[2:])


class YoloNeck(nn.Module):
    """The 5-conv block: 1x1 / 3x3 alternating, ending at `features`."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        chans = [in_features] + [features, features * 2] * 2 + [features]
        for i in range(5):
            setattr(self, f"DarknetConv_{i}",
                    DarknetConv(chans[i], chans[i + 1], 1 if i % 2 == 0 else 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = getattr(self, f"DarknetConv_{i}")(x)
        return x


class YoloHead(nn.Module):
    """3x3 DarknetConv + 1x1 conv with bias -> NHWC `(B, g, g, A, 5+C)`."""

    def __init__(self, in_features: int, features: int, num_anchors: int,
                 num_classes: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.num_classes = num_classes
        self.DarknetConv_0 = DarknetConv(in_features, features * 2, 3)
        self.Conv_0 = nn.Conv2d(features * 2,
                                num_anchors * (5 + num_classes), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(self.DarknetConv_0(x))
        b, _, g1, g2 = x.shape
        return x.permute(0, 2, 3, 1).reshape(
            b, g1, g2, self.num_anchors, 5 + self.num_classes)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    # nearest, exact 2x: output pixel i reads input i // 2, as
    # jax.image.resize(method="nearest") does at this ratio
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloV3(nn.Module):
    """NHWC images (B, s, s, 3) -> raw outputs (B, s/32, s/32, 3, 5+C),
    (B, s/16, ...), (B, s/8, ...)."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        self.num_classes = num_classes
        self.Darknet53_0 = Darknet53()
        self.YoloNeck_0 = YoloNeck(1024, 512)
        self.YoloHead_0 = YoloHead(512, 512, 3, num_classes)
        self.DarknetConv_0 = DarknetConv(512, 256, 1)
        self.YoloNeck_1 = YoloNeck(256 + 512, 256)
        self.YoloHead_1 = YoloHead(256, 256, 3, num_classes)
        self.DarknetConv_1 = DarknetConv(256, 128, 1)
        self.YoloNeck_2 = YoloNeck(128 + 256, 128)
        self.YoloHead_2 = YoloHead(128, 128, 3, num_classes)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c3, c4, c5 = (f.permute(0, 3, 1, 2) for f in self.Darknet53_0(images))
        n5 = self.YoloNeck_0(c5)
        out_large = self.YoloHead_0(n5)
        u5 = _upsample2x(self.DarknetConv_0(n5))
        n4 = self.YoloNeck_1(torch.cat([u5, c4], 1))
        out_medium = self.YoloHead_1(n4)
        u4 = _upsample2x(self.DarknetConv_1(n4))
        n3 = self.YoloNeck_2(torch.cat([u4, c3], 1))
        out_small = self.YoloHead_2(n3)
        return out_large, out_medium, out_small


@register_model("yolov3", init=reset_parameters)
def yolov3(num_classes: int = 80, **_):
    return YoloV3(num_classes=num_classes)


@register_model("darknet53", init=reset_parameters)
def darknet53(**_):
    return Darknet53()
