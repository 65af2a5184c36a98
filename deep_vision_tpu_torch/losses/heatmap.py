"""Pose heatmap and CenterNet losses, the port of
deep_vision_tpu/losses/heatmap.py (:24-93).

- `hourglass_loss_fn`: the Stacked Hourglass weighted MSE, every stack
  against the same ground truth, a pixel weighted 1 + 81 where the ground
  truth is above `fg_threshold` (Hourglass/tensorflow/train.py:65-76).
- `centernet_focal_loss`: the penalty-reduced pixel-wise focal loss
  (alpha 2, beta 4) over sigmoid probabilities clipped to [1e-6,
  1 - 1e-6), normalised by the positive count (at least 1).
- `_masked_l1` and `centernet_loss_fn`: the size (weight 0.1) and offset
  (weight 1) L1 at object centres, summed with the focal loss over the
  stacks; the last stack's terms are the metrics.

Tensors are NHWC, as the models return them and the batches carry
them: 'heatmap' (B, H, W, C), 'wh' and 'offset' (B, H, W, 2), 'mask'
(B, H, W).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

FOREGROUND_WEIGHT = 81.0  # Hourglass/tensorflow/train.py:69


def hourglass_loss_fn(outputs: List[torch.Tensor], batch: dict,
                      fg_threshold: float = 0.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: per-stack (B, H, W, K) heatmaps; batch['heatmap'] the
    ground truth. -> (loss, {'loss', 'last_stack_mse'})."""
    gt = batch["heatmap"]
    weights = torch.where(gt > fg_threshold, 1.0 + FOREGROUND_WEIGHT, 1.0)
    total = 0.0
    for hm in outputs:
        total = total + (torch.square(hm - gt) * weights).mean()
    metrics = {"loss": total,
               "last_stack_mse": torch.square(outputs[-1] - gt).mean()}
    return total, metrics


def centernet_focal_loss(pred_logits: torch.Tensor, gt: torch.Tensor,
                         alpha: float = 2.0, beta: float = 4.0
                         ) -> torch.Tensor:
    """Penalty-reduced pixel-wise focal loss, normalised by object count."""
    p = torch.clamp(torch.sigmoid(pred_logits), 1e-6, 1.0 - 1e-6)
    pos = torch.where(gt >= 1.0 - 1e-6, 1.0, 0.0)
    pos_loss = pos * torch.pow(1.0 - p, alpha) * torch.log(p)
    neg_loss = ((1.0 - pos) * torch.pow(1.0 - gt, beta)
                * torch.pow(p, alpha) * torch.log(1.0 - p))
    num_pos = torch.clamp_min(pos.sum(), 1.0)
    return -(pos_loss.sum() + neg_loss.sum()) / num_pos


def _masked_l1(pred: torch.Tensor, gt: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    num = torch.clamp_min(mask.sum(), 1.0)
    return ((pred - gt).abs() * mask[..., None]).sum() / num


def centernet_loss_fn(outputs: List[Dict[str, torch.Tensor]], batch: dict,
                      wh_weight: float = 0.1, offset_weight: float = 1.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: per-stack {'heatmap', 'wh', 'offset'} raw heads. ->
    (loss, {'loss', 'hm_loss', 'wh_loss', 'offset_loss'})."""
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    for i, head in enumerate(outputs):
        hm_loss = centernet_focal_loss(head["heatmap"], batch["heatmap"])
        wh_loss = _masked_l1(head["wh"], batch["wh"], batch["mask"])
        off_loss = _masked_l1(head["offset"], batch["offset"],
                              batch["mask"])
        total = total + hm_loss + wh_weight * wh_loss + \
            offset_weight * off_loss
        if i == len(outputs) - 1:
            metrics.update({"hm_loss": hm_loss, "wh_loss": wh_loss,
                            "offset_loss": off_loss})
    metrics["loss"] = total
    return total, metrics
