"""VGG-16/19, the port of deep_vision_tpu/models/vgg.py (vgg.py:21-48):
configs D and E.

NHWC images in, logits out. Each stage is `n` 3x3 ConvBNs with a bias
(he_normal kernels; without BatchNorm by default, as the reference
trains, with `use_bn=True` the modern variant), then a 2x2/2 max pool;
then Dense 4096, Dropout, Dense 4096, Dropout, the head. The flatten is
in the reference's NHWC order, so `Dense_0`'s input width depends on
`image_size` (default the registered configs' 224).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    ConvBN,
    Dense,
    Dropout,
    flatten_nhwc,
    max_pool,
    reset_flax_parameters,
)

CFG_D: Tuple[Tuple[int, int], ...] = ((2, 64), (2, 128), (3, 256), (3, 512),
                                      (3, 512))
CFG_E: Tuple[Tuple[int, int], ...] = ((2, 64), (2, 128), (4, 256), (4, 512),
                                      (4, 512))


class VGG(nn.Module):
    """`cfg`: (convs, channels) per stage."""

    def __init__(self, cfg: Sequence[Tuple[int, int]],
                 num_classes: int = 1000, dropout: float = 0.5,
                 use_bn: bool = False, image_size: int = 224):
        super().__init__()
        self.cfg = tuple(tuple(stage) for stage in cfg)
        prev, k = 3, 0
        for n_convs, ch in self.cfg:
            for _ in range(n_convs):
                setattr(self, f"ConvBN_{k}", ConvBN(prev, ch, 3, use_bn=use_bn,
                                                    use_bias=True))
                prev, k = ch, k + 1
        size = image_size // 2 ** len(self.cfg)
        self.Dense_0 = Dense(size * size * prev, 4096)
        self.Dropout_0 = Dropout(dropout)
        self.Dense_1 = Dense(4096, 4096)
        self.Dropout_1 = Dropout(dropout)
        self.Dense_2 = Dense(4096, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x, k = images.permute(0, 3, 1, 2), 0
        for n_convs, _ in self.cfg:
            for _ in range(n_convs):
                x = getattr(self, f"ConvBN_{k}")(x)
                k += 1
            x = max_pool(x, 2, 2)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        x = F.relu(self.Dense_1(self.Dropout_0(x)))
        return self.Dense_2(self.Dropout_1(x))


@register_model("vgg16", init=reset_flax_parameters)
def vgg16(num_classes: int = 1000, **kw):
    return VGG(CFG_D, num_classes=num_classes, **kw)


@register_model("vgg19", init=reset_flax_parameters)
def vgg19(num_classes: int = 1000, **kw):
    return VGG(CFG_E, num_classes=num_classes, **kw)
