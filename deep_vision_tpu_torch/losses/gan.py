"""GAN losses, the port of deep_vision_tpu/losses/gan.py (:17-48): DCGAN's
non-saturating sigmoid BCE for G and D, CycleGAN's LSGAN (MSE against
ones and zeros, D's halved), the cycle-consistency L1 (lambda 10) and
the identity L1 (lambda 5). The BCE is optax's
`sigmoid_binary_cross_entropy`, term for term:
-z log_sigmoid(x) - (1 - z) log_sigmoid(-x).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CYCLE_LAMBDA = 10.0
IDENTITY_LAMBDA = 5.0


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def bce_generator_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return sigmoid_binary_cross_entropy(
        fake_logits, torch.ones_like(fake_logits)).mean()


def bce_discriminator_loss(real_logits: torch.Tensor,
                           fake_logits: torch.Tensor) -> torch.Tensor:
    real = sigmoid_binary_cross_entropy(real_logits,
                                        torch.ones_like(real_logits))
    fake = sigmoid_binary_cross_entropy(fake_logits,
                                        torch.zeros_like(fake_logits))
    return real.mean() + fake.mean()


def lsgan_generator_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.square(fake_logits - 1.0).mean()


def lsgan_discriminator_loss(real_logits: torch.Tensor,
                             fake_logits: torch.Tensor) -> torch.Tensor:
    # 0.5 per the CycleGAN paper (slows D relative to G)
    return 0.5 * (torch.square(real_logits - 1.0).mean()
                  + torch.square(fake_logits).mean())


def cycle_consistency_loss(real: torch.Tensor, reconstructed: torch.Tensor,
                           weight: float = CYCLE_LAMBDA) -> torch.Tensor:
    return weight * (real - reconstructed).abs().mean()


def identity_loss(real: torch.Tensor, same: torch.Tensor,
                  weight: float = IDENTITY_LAMBDA) -> torch.Tensor:
    return weight * (real - same).abs().mean()
