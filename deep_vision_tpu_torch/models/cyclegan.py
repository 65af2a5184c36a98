"""CycleGAN's ResNet generator and 70x70 PatchGAN discriminator, the port
of deep_vision_tpu/models/cyclegan.py (:24-110).

NHWC images in and out. `_Norm` is the reference's: with `use_in` (the
default, the paper's recipe) instance normalisation over H and W per
sample and channel with its own `scale` and `bias` (plain PyTorch: no
batch statistics, so no moments kernel), else a training BatchNorm
(`BatchNorm_0`). The generator pads by reflection (7x7 stem and tail,
the residual blocks' 3x3 convolutions, all VALID), downsamples twice
with 3x3 stride-2 SAME convolutions and upsamples with flax
ConvTransposes; the discriminator's 4x4 SAME convolutions pad
asymmetrically where the total is odd (stride 1: one row before, two
after), as XLA does. Every kernel is drawn from normal(0.02), biases 0.
Submodules carry the flax auto-names (`_Norm_0`, `ResNetBlock_3`, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    instance_norm,
    reflect_pad,
    reset_flax_parameters,
)

INIT = "normal_0.02"


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _Norm(nn.Module):
    """Instance norm (`use_in`) with scale 1 / bias 0 at init, or a
    BatchNorm with the reference's momentum."""

    def __init__(self, features: int, use_in: bool = True):
        super().__init__()
        self.use_in = use_in
        if use_in:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_in:
            return self.BatchNorm_0(x)
        return (instance_norm(x) * self.scale.view(1, -1, 1, 1)
                + self.bias.view(1, -1, 1, 1))


class ResNetBlock(nn.Module):
    def __init__(self, features: int, use_in: bool = True):
        super().__init__()
        self.Conv_0 = Conv(features, features, 3, padding="VALID",
                           kernel_init=INIT)
        self._Norm_0 = _Norm(features, use_in)
        self.Conv_1 = Conv(features, features, 3, padding="VALID",
                           kernel_init=INIT)
        self._Norm_1 = _Norm(features, use_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self._Norm_0(self.Conv_0(reflect_pad(x, 1))))
        y = self._Norm_1(self.Conv_1(reflect_pad(y, 1)))
        return x + y


class CycleGanGenerator(nn.Module):
    def __init__(self, n_blocks: int = 9, base: int = 64,
                 use_in: bool = True, in_features: int = 3):
        super().__init__()
        self.n_blocks = n_blocks
        self.Conv_0 = Conv(in_features, base, 7, padding="VALID",
                           kernel_init=INIT)
        self._Norm_0 = _Norm(base, use_in)
        self.Conv_1 = Conv(base, base * 2, 3, 2, kernel_init=INIT)
        self._Norm_1 = _Norm(base * 2, use_in)
        self.Conv_2 = Conv(base * 2, base * 4, 3, 2, kernel_init=INIT)
        self._Norm_2 = _Norm(base * 4, use_in)
        for i in range(n_blocks):
            setattr(self, f"ResNetBlock_{i}", ResNetBlock(base * 4, use_in))
        self.ConvTranspose_0 = ConvTranspose(base * 4, base * 2, 3, 2,
                                             kernel_init=INIT)
        self._Norm_3 = _Norm(base * 2, use_in)
        self.ConvTranspose_1 = ConvTranspose(base * 2, base, 3, 2,
                                             kernel_init=INIT)
        self._Norm_4 = _Norm(base, use_in)
        self.Conv_3 = Conv(base, 3, 7, padding="VALID", kernel_init=INIT)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = reflect_pad(images.permute(0, 3, 1, 2), 3)
        x = F.relu(self._Norm_0(self.Conv_0(x)))
        x = F.relu(self._Norm_1(self.Conv_1(x)))
        x = F.relu(self._Norm_2(self.Conv_2(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"ResNetBlock_{i}")(x)
        x = F.relu(self._Norm_3(self.ConvTranspose_0(x)))
        x = F.relu(self._Norm_4(self.ConvTranspose_1(x)))
        x = self.Conv_3(reflect_pad(x, 3))
        return torch.tanh(x).permute(0, 2, 3, 1)


class PatchGanDiscriminator(nn.Module):
    """70x70 PatchGAN: 4x4 convolutions -> (B, H/8, W/8, 1) patch logits."""

    def __init__(self, base: int = 64, use_in: bool = True,
                 in_features: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_features, base, 4, 2, kernel_init=INIT)
        self.Conv_1 = Conv(base, base * 2, 4, 2, kernel_init=INIT)
        self._Norm_0 = _Norm(base * 2, use_in)
        self.Conv_2 = Conv(base * 2, base * 4, 4, 2, kernel_init=INIT)
        self._Norm_1 = _Norm(base * 4, use_in)
        self.Conv_3 = Conv(base * 4, base * 8, 4, 1, kernel_init=INIT)
        self._Norm_2 = _Norm(base * 8, use_in)
        self.Conv_4 = Conv(base * 8, 1, 4, 1, kernel_init=INIT)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = _leaky(self.Conv_0(images.permute(0, 3, 1, 2)))
        x = _leaky(self._Norm_0(self.Conv_1(x)))
        x = _leaky(self._Norm_1(self.Conv_2(x)))
        x = _leaky(self._Norm_2(self.Conv_3(x)))
        return self.Conv_4(x).permute(0, 2, 3, 1)


@register_model("cyclegan_generator", init=reset_flax_parameters)
def cyclegan_generator(n_blocks: int = 9, **kw):
    return CycleGanGenerator(n_blocks=n_blocks, **kw)


@register_model("cyclegan_discriminator", init=reset_flax_parameters)
def cyclegan_discriminator(**kw):
    return PatchGanDiscriminator(**kw)
