"""ShuffleNet V1, the port of deep_vision_tpu/models/shufflenet.py
(shufflenet.py:24-69): group convolutions and the channel shuffle, with
g groups (3 registered) and the scale `s`.

NHWC images in, logits out: a 3x3/2 ConvBN stem (24 channels), a 3x3/2
SAME max pool, three stages of ShuffleUnits (4, 8, 4; the first of each
strided), global average pooling and the head. A unit is a 1x1 group
ConvBN with ReLU (the bn_act kernel; the very first unit's is not
grouped), the channel shuffle, a depthwise 3x3 ConvBN and a 1x1 group
ConvBN, both without an activation (unfused BatchNorms); then ReLU of
the skip sum, or of the concatenation with a 3x3/2 SAME average pool
(padded zeros counted) for a strided unit. 17 BatchNorms of a step run
through the bn_act kernel, 49 take batch moments. Every tensor stays
channels_last: `channel_shuffle` works on the NHWC view, and the
concatenation and pools keep their inputs' layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    ConvBN,
    Dense,
    avg_pool,
    channel_shuffle,
    global_avg_pool,
    max_pool,
    reset_flax_parameters,
)

#: output channels per stage for each group count (the paper's table 1)
STAGE_CH = {1: (144, 288, 576), 2: (200, 400, 800), 3: (240, 480, 960),
            4: (272, 544, 1088), 8: (384, 768, 1536)}
STAGE_REPEATS = (4, 8, 4)


class ShuffleUnit(nn.Module):
    def __init__(self, in_features: int, features: int, groups: int,
                 stride: int = 1, first_stage: bool = False):
        super().__init__()
        bottleneck = features // 4
        out = features - in_features if stride == 2 else features
        self.stride = stride
        self.g = 1 if first_stage else groups
        self.ConvBN_0 = ConvBN(in_features, bottleneck, 1, groups=self.g)
        self.ConvBN_1 = ConvBN(bottleneck, bottleneck, 3, stride,
                               groups=bottleneck, act=None)
        self.ConvBN_2 = ConvBN(bottleneck, out, 1, groups=groups, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBN_0(x)
        if self.g > 1:
            y = channel_shuffle(y, self.g)
        y = self.ConvBN_2(self.ConvBN_1(y))
        if self.stride == 2:
            shortcut = avg_pool(x, 3, 2, "SAME")
            return F.relu(torch.cat([shortcut, y], dim=1))
        return F.relu(x + y)


class ShuffleNetV1(nn.Module):
    def __init__(self, num_classes: int = 1000, groups: int = 3,
                 scale: float = 1.0):
        super().__init__()
        stage_ch = [max(8, int(c * scale)) for c in STAGE_CH[groups]]
        self.ConvBN_0 = ConvBN(3, 24, 3, 2)
        prev, k = 24, 0
        for stage, (ch, repeats) in enumerate(zip(stage_ch, STAGE_REPEATS)):
            for j in range(repeats):
                setattr(self, f"ShuffleUnit_{k}", ShuffleUnit(
                    prev, ch, groups, stride=2 if j == 0 else 1,
                    first_stage=stage == 0 and j == 0))
                prev, k = ch, k + 1
        self.num_units = k
        self.Dense_0 = Dense(prev, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.ConvBN_0(images.permute(0, 3, 1, 2))
        x = max_pool(x, 3, 2, "SAME")
        for k in range(self.num_units):
            x = getattr(self, f"ShuffleUnit_{k}")(x)
        return self.Dense_0(global_avg_pool(x))


@register_model("shufflenet1", init=reset_flax_parameters)
def shufflenet_v1(num_classes: int = 1000, groups: int = 3,
                  scale: float = 1.0, **_):
    return ShuffleNetV1(num_classes=num_classes, groups=groups, scale=scale)
