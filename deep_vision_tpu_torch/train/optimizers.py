"""Optimizers and schedules, the port of deep_vision_tpu/train/optimizers.py:
SGD with momentum and AdamW, both with masked weight decay, and the
warmup + cosine schedule. Other optimizers and schedules, gradient
clipping and low-precision optimizer state are not ported yet.

SGD: the reference chains `optax.add_decayed_weights(wd, mask)` and
`optax.sgd(lr, momentum, nesterov)`: u = g + wd * p where the mask
allows it, then the trace t = u + m * t from zeros, then
p -= lr * t (nesterov: p -= lr * (u + m * t)). `torch.optim.SGD` with
two parameter groups (weight decay wd and 0) computes the same
arithmetic.

AdamW: the reference calls `optax.adamw(lr, b1, b2, weight_decay=wd,
mask)` and passes no eps, so optax's default 1e-8 always holds:
p -= lr * (m_hat / (sqrt(v_hat) + 1e-8) + wd * p). `torch.optim.AdamW`
decays first (p *= 1 - lr * wd), then takes the same Adam step: the
same arithmetic up to rounding. eps (1e-8) and weight_decay are passed
explicitly (torch's AdamW defaults to weight_decay 1e-2); any other eps
for "adamw" raises, since the reference would ignore it. "sgd" ignores
eps.

The mask is by flax name (`_decay_mask`, optimizers.py:29-40): a
parameter is exempt when its name ends in `bias` or `scale` or contains
`BatchNorm`; `decay_bn_bias=True` decays everything.

The learning rate is a float or a schedule, step -> lr. With a schedule
the optimizer starts at schedule(0), and the Trainer sets every group to
schedule(step) before each update, where step counts the updates taken,
as optax's `inject_hyperparams` counts them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch
from torch import nn

from deep_vision_tpu_torch.convert import flax_path

Schedule = Union[float, Callable[[int], float]]
#: optax.adamw's default eps, the only one the reference's adamw uses
ADAMW_EPS = 1e-8


def decay_mask(names: Iterable[str], decay_bn_bias: bool) -> Dict[str, bool]:
    """state_dict parameter names -> True where weight decay applies."""
    mask = {}
    for name in names:
        path = flax_path(name)
        exempt = (path.endswith("bias") or "BatchNorm" in path
                  or path.endswith("scale"))
        mask[name] = decay_bn_bias or not exempt
    return mask


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule(0, base_lr, warmup_steps,
    total_steps, end_lr)`: linear from 0 to base_lr over warmup_steps,
    then a cosine from base_lr to end_lr over total_steps - warmup_steps,
    end_lr after."""
    if total_steps - warmup_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr
    decay = total_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * max(step, 0) / warmup_steps
        count = min(step - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_schedule(kind: str = "constant", base_lr: float = 0.1,
                  **kw) -> Schedule:
    """The reference's named schedules: "constant" (base_lr) and
    "cosine" (warmup_steps, total_steps, end_lr; warmup at least 1 step,
    as the reference clamps it)."""
    if kind == "constant":
        return base_lr
    if kind == "cosine":
        return warmup_cosine(base_lr, max(kw.get("warmup_steps", 0), 1),
                             kw["total_steps"], kw.get("end_lr", 0.0))
    raise ValueError(f"schedule {kind!r} is not ported yet (constant and "
                     f"cosine are)")


@dataclass(frozen=True)
class OptimizerSpec:
    """What `build_optimizer` returns: call it on a model to get the
    torch optimizer over that model's parameters, in two groups (weight
    decay `weight_decay` where the mask allows it, 0 elsewhere)."""

    name: str
    learning_rate: Schedule
    weight_decay: float = 0.0
    decay_bn_bias: bool = False
    momentum: float = 0.0
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.999

    @property
    def schedule(self) -> Optional[Callable[[int], float]]:
        return self.learning_rate if callable(self.learning_rate) else None

    def groups(self, model: nn.Module) -> List[dict]:
        named = list(model.named_parameters())
        mask = decay_mask((n for n, _ in named), self.decay_bn_bias)
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": self.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0},
        ]
        return [g for g in groups if g["params"]]

    def __call__(self, model: nn.Module) -> torch.optim.Optimizer:
        lr = self.schedule(0) if self.schedule else self.learning_rate
        if self.name == "sgd":
            return torch.optim.SGD(
                self.groups(model), lr=lr, momentum=self.momentum,
                nesterov=self.nesterov and self.momentum > 0)
        return torch.optim.AdamW(self.groups(model), lr=lr,
                                 betas=(self.b1, self.b2), eps=ADAMW_EPS)


def build_optimizer(name: str, learning_rate: Schedule, *,
                    weight_decay: float = 0.0, decay_bn_bias: bool = False,
                    momentum: float = 0.0, nesterov: bool = False,
                    b1: float = 0.9, b2: float = 0.999,
                    eps: float = ADAMW_EPS) -> OptimizerSpec:
    """The reference's `build_optimizer` for "sgd" (momentum, nesterov)
    and "adamw" (b1, b2); `learning_rate` a float or a schedule. eps
    exists for the reference's signature: "sgd" ignores it, and "adamw"
    takes only ADAMW_EPS, the one value the reference uses."""
    if name not in ("sgd", "adamw"):
        raise ValueError(f"optimizer {name!r} is not ported yet (sgd and "
                         f"adamw are)")
    if name == "adamw" and eps != ADAMW_EPS:
        raise ValueError(
            f"adamw eps={eps!r}: the reference's adamw ignores eps and "
            f"always uses optax's {ADAMW_EPS}; pass no eps")
    if not callable(learning_rate):
        learning_rate = float(learning_rate)
    return OptimizerSpec(name, learning_rate, float(weight_decay),
                         bool(decay_bn_bias), float(momentum), bool(nesterov),
                         float(b1), float(b2))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate to an absolute value (`_set_lr`,
    trainer.py:53)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
