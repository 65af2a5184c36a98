"""Model accounting, the part of deep_vision_tpu/core/summary.py that the
training CLI prints: `count_params`. The per-layer summary table is not
ported yet."""
from __future__ import annotations

from torch import nn


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm running statistics are buffers,
    not counted, as the reference counts `params` only)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
