"""Optimizers, the port of deep_vision_tpu/train/optimizers.py: SGD with
momentum and masked weight decay. Other optimizers, schedules, gradient
clipping and low-precision optimizer state are not ported yet.

The reference chains `optax.add_decayed_weights(wd, mask)` and
`optax.sgd(lr, momentum, nesterov)`: u = g + wd * p where the mask
allows it, then the trace t = u + m * t from zeros, then
p -= lr * t (nesterov: p -= lr * (u + m * t)). `torch.optim.SGD` with
two parameter groups (weight decay wd and 0) computes the same
arithmetic. The mask is by flax name (`_decay_mask`, optimizers.py:29-40):
a parameter is exempt when its name ends in `bias` or `scale` or
contains `BatchNorm`; `decay_bn_bias=True` decays everything.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

import torch
from torch import nn

from deep_vision_tpu_torch.convert import flax_path


def decay_mask(names: Iterable[str], decay_bn_bias: bool) -> Dict[str, bool]:
    """state_dict parameter names -> True where weight decay applies."""
    mask = {}
    for name in names:
        path = flax_path(name)
        exempt = (path.endswith("bias") or "BatchNorm" in path
                  or path.endswith("scale"))
        mask[name] = decay_bn_bias or not exempt
    return mask


@dataclass(frozen=True)
class SGDSpec:
    """What `build_optimizer("sgd", ...)` returns: call it on a model to
    get the `torch.optim.SGD` over that model's parameters."""

    learning_rate: float
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    decay_bn_bias: bool = False

    def __call__(self, model: nn.Module) -> torch.optim.SGD:
        named = list(model.named_parameters())
        mask = decay_mask((n for n, _ in named), self.decay_bn_bias)
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": self.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0},
        ]
        return torch.optim.SGD(
            [g for g in groups if g["params"]], lr=self.learning_rate,
            momentum=self.momentum,
            nesterov=self.nesterov and self.momentum > 0)


def build_optimizer(name: str, learning_rate: float, *,
                    weight_decay: float = 0.0, decay_bn_bias: bool = False,
                    momentum: float = 0.0, nesterov: bool = False) -> SGDSpec:
    """The reference's `build_optimizer` for "sgd" with a constant
    learning rate."""
    if name != "sgd":
        raise ValueError(f"optimizer {name!r} is not ported yet (sgd is)")
    if callable(learning_rate):
        raise TypeError("learning-rate schedules are not ported yet: pass a "
                        "float")
    return SGDSpec(float(learning_rate), float(momentum), bool(nesterov),
                   float(weight_decay), bool(decay_bn_bias))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate to an absolute value (`_set_lr`,
    trainer.py:53)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
