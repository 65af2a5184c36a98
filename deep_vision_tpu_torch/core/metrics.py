"""Metrics computed inside a step: the port of `topk_accuracy`
(deep_vision_tpu/core/metrics.py:25-41). The host-side MetricLogger is
not ported yet."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5),
                  weights: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Top-k accuracy fractions over int class ids `labels` (B,).
    `weights` (B,) masks padded rows. A stable descending sort orders
    tied logits by class index, as `jnp.argsort(-logits)` does."""
    maxk = max(ks)
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :maxk]
    correct = topk == labels[:, None]
    if weights is None:
        weights = torch.ones(labels.shape, dtype=logits.dtype,
                             device=logits.device)
    denom = torch.clamp_min(weights.sum(), 1e-9)
    return {f"top{k}": (correct[:, :k].any(dim=-1) * weights).sum() / denom
            for k in ks}
