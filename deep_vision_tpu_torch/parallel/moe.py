"""Mixture-of-experts pieces of deep_vision_tpu/parallel/moe.py that one
device needs: the Switch load-balancing loss. The expert-parallel
dispatch over a mesh is not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def load_balancing_loss(gates: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer auxiliary loss E * sum_e f_e * P_e
    (moe.py:154-168). gates: (T, E) softmax router outputs; f_e is the
    share of tokens whose arg-max picks expert e, P_e the mean gate of e.
    It is 1 when routing is uniform."""
    e = gates.shape[-1]
    f = F.one_hot(gates.argmax(dim=-1), e).to(gates.dtype).mean(dim=0)
    return e * (f * gates.mean(dim=0)).sum()
