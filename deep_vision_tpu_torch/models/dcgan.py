"""DCGAN for MNIST 28x28, the port of deep_vision_tpu/models/dcgan.py
(:18-60).

Generator: z (B, latent) -> Dense 7 * 7 * 256 without bias -> BatchNorm
over the (B, 12544) matrix -> leaky 0.2 -> reshape to NHWC (B, 7, 7,
256) -> three 5x5 ConvTransposes (strides 1, 2, 2; the first two each
followed by BatchNorm and leaky 0.2) -> tanh, NHWC (B, 28, 28, 1) out.
The Dense output is in the reference's NHWC order: it is reshaped to
(B, 7, 7, 256) and only then permuted to the port's NCHW indexing (a
channels_last view). Discriminator: NHWC images -> two 5x5 stride-2
SAME convolutions, each with leaky 0.2 and Dropout 0.3 -> flatten in NHWC
order (`flatten_nhwc`) -> Dense 1 logit. Every kernel is drawn from
normal(0.02), biases 0. The BatchNorms run without an activation, so
their batch statistics go through the moments kernels (the first one
through the contiguous 2-D route) and the apply stays unfused.
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
    Dense,
    Dropout,
    flatten_nhwc,
    reset_flax_parameters,
)

INIT = "normal_0.02"


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class Generator(nn.Module):
    def __init__(self, latent_dim: int = 100):
        super().__init__()
        self.Dense_0 = Dense(latent_dim, 7 * 7 * 256, kernel_init=INIT,
                             use_bias=False)
        self.BatchNorm_0 = BatchNorm(7 * 7 * 256)
        self.ConvTranspose_0 = ConvTranspose(256, 128, 5, 1, use_bias=False,
                                             kernel_init=INIT)
        self.BatchNorm_1 = BatchNorm(128)
        self.ConvTranspose_1 = ConvTranspose(128, 64, 5, 2, use_bias=False,
                                             kernel_init=INIT)
        self.BatchNorm_2 = BatchNorm(64)
        self.ConvTranspose_2 = ConvTranspose(64, 1, 5, 2, use_bias=False,
                                             kernel_init=INIT)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _leaky(self.BatchNorm_0(self.Dense_0(z)))
        x = x.reshape(-1, 7, 7, 256).permute(0, 3, 1, 2)
        x = _leaky(self.BatchNorm_1(self.ConvTranspose_0(x)))
        x = _leaky(self.BatchNorm_2(self.ConvTranspose_1(x)))
        return torch.tanh(self.ConvTranspose_2(x)).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    def __init__(self, in_features: int = 1, image_size: int = 28):
        super().__init__()
        self.Conv_0 = Conv(in_features, 64, 5, 2, kernel_init=INIT)
        self.Dropout_0 = Dropout(0.3)
        self.Conv_1 = Conv(64, 128, 5, 2, kernel_init=INIT)
        self.Dropout_1 = Dropout(0.3)
        side = -(-(-(-image_size // 2)) // 2)  # two SAME stride-2 convs
        self.Dense_0 = Dense(side * side * 128, 1, kernel_init=INIT)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.Dropout_0(_leaky(self.Conv_0(images.permute(0, 3, 1, 2))))
        x = self.Dropout_1(_leaky(self.Conv_1(x)))
        return self.Dense_0(flatten_nhwc(x))


@register_model("dcgan_generator", init=reset_flax_parameters)
def dcgan_generator(latent_dim: int = 100, **_):
    return Generator(latent_dim=latent_dim)


@register_model("dcgan_discriminator", init=reset_flax_parameters)
def dcgan_discriminator(**_):
    return Discriminator()
