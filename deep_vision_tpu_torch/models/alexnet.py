"""AlexNet V1 and V2, the port of deep_vision_tpu/models/alexnet.py
(alexnet.py:18-78).

NHWC images in, logits out. V1: 11x11/4 VALID, ReLU and
LocalResponseNorm (the reference's formula, not torch's), 3x3/2 max
pools, then 5x5, three 3x3 convs, a pool, and the classifier; V2 drops
the LRN and narrows the first two convs. The classifier flattens in the
reference's NHWC order, so `Dense_0`'s input width depends on the image
size (`image_size`, default the registered configs' 224), as flax infers
it at init. Dropout 0.5 before each hidden Dense, from the generator set
on the Dropout modules (nn/layers.py `set_dropout_generator`). Weights
as flax draws them: lecun_normal kernels, zero biases.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    Conv,
    Dense,
    Dropout,
    LocalResponseNorm,
    flatten_nhwc,
    max_pool,
    reset_flax_parameters,
)


def _pooled(size: int) -> int:
    """A 3x3/2 VALID max pool's output size."""
    return (size - 3) // 2 + 1


class AlexNet(nn.Module):
    """`v1`: the one-tower original with LRN (96/256 wide first convs);
    else V2 (64/192, no LRN, padded 11x11 stem)."""

    def __init__(self, v1: bool, num_classes: int = 1000,
                 dropout: float = 0.5, image_size: int = 224):
        super().__init__()
        self.v1 = v1
        c0, c1 = (96, 256) if v1 else (64, 192)
        stem_pad = "VALID" if v1 else [(2, 2), (2, 2)]
        self.Conv_0 = Conv(3, c0, 11, 4, stem_pad)
        self.Conv_1 = Conv(c0, c1, 5, padding=[(2, 2), (2, 2)])
        self.Conv_2 = Conv(c1, 384, 3)
        self.Conv_3 = Conv(384, 384 if v1 else 256, 3)
        self.Conv_4 = Conv(384 if v1 else 256, 256, 3)
        if v1:
            self.LocalResponseNorm_0 = LocalResponseNorm()
            self.LocalResponseNorm_1 = LocalResponseNorm()
        size = (image_size + (0 if v1 else 4) - 11) // 4 + 1
        size = _pooled(_pooled(_pooled(size)))
        self.Dropout_0 = Dropout(dropout)
        self.Dense_0 = Dense(size * size * 256, 4096)
        self.Dropout_1 = Dropout(dropout)
        self.Dense_1 = Dense(4096, 4096)
        self.Dense_2 = Dense(4096, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Conv_0(images.permute(0, 3, 1, 2)))
        if self.v1:
            x = self.LocalResponseNorm_0(x)
        x = F.relu(self.Conv_1(max_pool(x, 3, 2)))
        if self.v1:
            x = self.LocalResponseNorm_1(x)
        x = max_pool(x, 3, 2)
        for conv in (self.Conv_2, self.Conv_3, self.Conv_4):
            x = F.relu(conv(x))
        x = flatten_nhwc(max_pool(x, 3, 2))
        x = F.relu(self.Dense_0(self.Dropout_0(x)))
        x = F.relu(self.Dense_1(self.Dropout_1(x)))
        return self.Dense_2(x)


@register_model("alexnet1", init=reset_flax_parameters)
def alexnet_v1(num_classes: int = 1000, dropout: float = 0.5,
               image_size: int = 224, **_):
    return AlexNet(True, num_classes, dropout, image_size)


@register_model("alexnet2", init=reset_flax_parameters)
def alexnet_v2(num_classes: int = 1000, dropout: float = 0.5,
               image_size: int = 224, **_):
    return AlexNet(False, num_classes, dropout, image_size)
