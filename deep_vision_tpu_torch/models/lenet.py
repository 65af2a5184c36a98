"""LeNet-5, the port of deep_vision_tpu/models/lenet.py (lenet.py:16-38).

NHWC images `(B, 32, 32, 1)` in, logits out: three 5x5 VALID convs with
tanh, 2x2 average pools after the first two, then Dense 84 (tanh) and
the head. The flatten is in the reference's NHWC order. Weights as flax
draws them: lecun_normal kernels, zero biases.
"""
from __future__ import annotations

import torch
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    Conv,
    Dense,
    avg_pool,
    flatten_nhwc,
    reset_flax_parameters,
)


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, in_features: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_features, 6, 5, padding="VALID")
        self.Conv_1 = Conv(6, 16, 5, padding="VALID")
        self.Conv_2 = Conv(16, 120, 5, padding="VALID")
        self.Dense_0 = Dense(120, 84)
        self.Dense_1 = Dense(84, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        x = avg_pool(torch.tanh(self.Conv_0(x)), 2, 2)
        x = avg_pool(torch.tanh(self.Conv_1(x)), 2, 2)
        x = flatten_nhwc(torch.tanh(self.Conv_2(x)))
        return self.Dense_1(torch.tanh(self.Dense_0(x)))


@register_model("lenet5", init=reset_flax_parameters)
def lenet5(num_classes: int = 10, **_):
    return LeNet5(num_classes=num_classes)
