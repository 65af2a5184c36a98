"""Exponential moving average of the parameters, for evaluation.

The port of deep_vision_tpu/train/ema.py:1-73. `EmaParams` keeps a
float32 shadow of a model's **parameters only** (BatchNorm running
statistics are buffers, and evaluation reads the live ones, as the
reference's eval_step swaps in the shadow params beside the live
batch_stats). Each `update` is the reference's
`e * d + p * (1 - d)` with the warmup decay `d = min(decay,
(1 + n) / (10 + n))`, written with `torch._foreach_mul_` /
`_foreach_add_` over the whole list in one pass.

`params` maps state_dict parameter names to the shadow tensors; the
Trainer evaluates through `torch.func.functional_call` with them, so
the training model's own parameters are never swapped.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class EmaParams:
    """Float32 shadow of a model's parameters, EMA-updated in place."""

    def __init__(self, model: nn.Module, decay: float = 0.999,
                 warmup: bool = True):
        self.decay = float(decay)
        self.warmup = warmup
        self._count = 0
        self.params: Dict[str, torch.Tensor] = {
            n: p.detach().to(torch.float32, copy=True)
            for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self._count += 1
        d = self.decay
        if self.warmup:
            # zero-debias: ramp the decay so the early steps are not
            # dominated by the initial weights
            d = min(d, (1.0 + self._count) / (10.0 + self._count))
        shadow = list(self.params.values())
        live = [p.detach() for _, p in model.named_parameters()]
        live = [p if p.dtype == torch.float32 else p.float() for p in live]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, torch._foreach_mul(live, 1.0 - d))

    def state_dict(self) -> dict:
        return {"count": self._count, "decay": self.decay,
                "warmup": self.warmup}

    def load_state_dict(self, d: dict) -> None:
        self._count = int(d.get("count", 0))
        self.decay = float(d.get("decay", self.decay))
        self.warmup = bool(d.get("warmup", self.warmup))
