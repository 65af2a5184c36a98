"""Classification losses, the port of
deep_vision_tpu/losses/classification.py: softmax cross entropy with
label smoothing and row weights, and the loss function over logits or
`(logits, *aux)` outputs."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deep_vision_tpu_torch.core.metrics import topk_accuracy

RESERVED = ("loss", "top1", "top5")


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean softmax cross entropy over int class ids. The targets are
    smoothed as `optax.smooth_labels` does, `(1 - a) * onehot + a / C`;
    `weights` (B,) masks padded rows: sum(ce * w) / max(sum(w), 1e-9)."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).float()
    onehot = (1.0 - label_smoothing) * onehot + label_smoothing / num_classes
    ce = -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    if weights is None:
        return ce.mean()
    return (ce * weights).sum() / torch.clamp_min(weights.sum(), 1e-9)


def classification_loss_fn(outputs, batch: dict, aux_weight: float = 0.3,
                           label_smoothing: float = 0.0,
                           penalty_weight: float = 0.01):
    """(loss, metrics) from model outputs (logits or (logits, *aux)) and a
    batch {'label': (B,) ints, optional '_mask': (B,) weights}.

    An aux entry is either logits (an Inception head: cross entropy added
    at `aux_weight`) or a dict of named scalar penalties (added at
    `penalty_weight` and surfaced as metrics). A '_'-prefixed name is a
    diagnostic metric, surfaced without the prefix and never added to the
    loss. Names that collide with 'loss', 'top1', 'top5' or with each
    other raise."""
    labels = batch["label"]
    weights = batch.get("_mask")
    aux_logits = ()
    if isinstance(outputs, (tuple, list)):
        logits, *aux_logits = outputs
    else:
        logits = outputs
    loss = cross_entropy_loss(logits, labels, label_smoothing, weights)
    metrics = {}
    for aux in aux_logits:
        if aux is None:
            continue
        if not isinstance(aux, dict):
            loss = loss + aux_weight * cross_entropy_loss(
                aux, labels, label_smoothing, weights)
            continue
        for name, value in aux.items():
            if name.startswith("_"):
                if name[1:] in RESERVED:
                    raise ValueError(
                        f"aux metric name {name!r} collides with a reserved "
                        "metric key; rename it")
                if name[1:] in metrics:
                    raise ValueError(
                        f"duplicate aux metric name {name[1:]!r}; rename one "
                        "of the colliding aux outputs")
                metrics[name[1:]] = value
                continue
            if name in RESERVED:
                raise ValueError(
                    f"aux penalty name {name!r} collides with a reserved "
                    f"metric key; rename it (e.g. 'aux_{name}')")
            if name in metrics:
                raise ValueError(
                    f"duplicate aux penalty name {name!r}; rename one of the "
                    "colliding aux outputs")
            loss = loss + penalty_weight * value
            metrics[name] = value
    metrics["loss"] = loss
    metrics.update(topk_accuracy(logits, labels, weights=weights))
    return loss, metrics
