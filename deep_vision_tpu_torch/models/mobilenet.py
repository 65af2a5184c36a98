"""MobileNet V1, the port of deep_vision_tpu/models/mobilenet.py
(mobilenet.py:34-56), with the width multiplier `alpha`.

NHWC images in, logits out: a 3x3/2 ConvBN stem, 13 depthwise-separable
blocks (a depthwise 3x3 ConvBN, groups = channels, and a pointwise 1x1
ConvBN; each ReLU folds into its BatchNorm, so all 27 BatchNorms run
through the bn_act kernel), global average pooling, Dropout(0.001) and
the head. Channels are `max(8, int(ch * alpha))`. Depthwise convolutions
stay `F.conv2d(groups=)`, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    ConvBN,
    Dense,
    DepthwiseSeparableConv,
    Dropout,
    global_avg_pool,
    reset_flax_parameters,
)

#: (features, stride) after the stem; features are before alpha
CFG = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
       (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))


class MobileNetV1(nn.Module):
    def __init__(self, num_classes: int = 1000, alpha: float = 1.0,
                 dropout: float = 0.001):
        super().__init__()

        def scaled(ch):
            return max(8, int(ch * alpha))

        prev = scaled(32)
        self.ConvBN_0 = ConvBN(3, prev, 3, 2)
        for i, (features, stride) in enumerate(CFG):
            setattr(self, f"DepthwiseSeparableConv_{i}",
                    DepthwiseSeparableConv(prev, scaled(features), stride))
            prev = scaled(features)
        self.Dropout_0 = Dropout(dropout)
        self.Dense_0 = Dense(prev, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.ConvBN_0(images.permute(0, 3, 1, 2))
        for i in range(len(CFG)):
            x = getattr(self, f"DepthwiseSeparableConv_{i}")(x)
        return self.Dense_0(self.Dropout_0(global_avg_pool(x)))


@register_model("mobilenet1", init=reset_flax_parameters)
def mobilenet_v1(num_classes: int = 1000, alpha: float = 1.0,
                 dropout: float = 0.001, **_):
    return MobileNetV1(num_classes=num_classes, alpha=alpha, dropout=dropout)
