"""The YOLOv3 loss, the port of deep_vision_tpu/losses/yolo.py:
`yolo_loss_per_scale`, `yolo_loss_fn` and `yolo_train_loss_fn`.

Per scale: the box regression in t-space (`encode_yolo_boxes`) weighted
by 2 - w*h and `LAMBDA_COORD`; the objectness and class terms as
sigmoid binary cross entropy in optax's form; background cells whose
decoded box overlaps any ground-truth box by IoU > `ignore_thresh`
are left out of the no-object term. Each term is summed over an image
and averaged over the batch. `yolo_train_loss_fn` builds the target
grids from the batch's padded boxes (`ops/anchors.py`) inside the step.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deep_vision_tpu_torch.ops.anchors import (
    YOLO_ANCHOR_MASKS,
    YOLO_ANCHORS,
    assign_anchors_to_grid,
)
from deep_vision_tpu_torch.ops.boxes import (
    broadcast_iou,
    decode_yolo_boxes,
    encode_yolo_boxes,
    xywh_to_xyxy,
    xyxy_to_xywh,
)

LAMBDA_COORD = 5.0
LAMBDA_NOOBJ = 0.5
SCALE_NAMES = ("large", "medium", "small")


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: -y log s(x) - (1 - y) log s(-x)."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def best_iou(pred: torch.Tensor, gt_boxes: torch.Tensor,
             anchors: torch.Tensor) -> torch.Tensor:
    """(B, g, g, A): each decoded prediction's largest IoU with the
    image's ground-truth boxes (xywh; padded rows have IoU 0), without
    gradient: it only decides the ignore mask."""
    b, gy, gx, na, _ = pred.shape
    with torch.no_grad():
        pred_boxes, _, _ = decode_yolo_boxes(pred, anchors)
        iou = broadcast_iou(pred_boxes.reshape(b, -1, 4),
                            xywh_to_xyxy(gt_boxes))
        return iou.amax(dim=-1).reshape(b, gy, gx, na)


def yolo_loss_per_scale(pred: torch.Tensor, target: torch.Tensor,
                        gt_boxes: torch.Tensor, anchors: torch.Tensor,
                        ignore_thresh: float = 0.5
                        ) -> Dict[str, torch.Tensor]:
    """pred (B, g, g, A, 5+C) raw logits; target the same shape;
    gt_boxes (B, N, 4) xywh; anchors (A, 2). -> {xy, wh, obj, noobj,
    class, total}."""
    b, gy, gx, na, _ = pred.shape
    obj_mask = target[..., 4]
    true_xywh = target[..., 0:4]
    t_true = encode_yolo_boxes(true_xywh, anchors, gy)
    box_scale = torch.where(
        obj_mask > 0, 2.0 - true_xywh[..., 2] * true_xywh[..., 3], 0.0)
    weight = box_scale * obj_mask
    xy_loss = (torch.sigmoid(pred[..., 0:2]) - t_true[..., 0:2]).square() \
        .sum(dim=-1) * weight
    wh_loss = (pred[..., 2:4] - t_true[..., 2:4]).square().sum(dim=-1) \
        * weight
    ignore = (best_iou(pred, gt_boxes, anchors) > ignore_thresh).to(
        pred.dtype)
    obj_bce = sigmoid_bce(pred[..., 4], obj_mask)
    obj_loss = obj_mask * obj_bce
    noobj_loss = (1.0 - obj_mask) * (1.0 - ignore) * obj_bce
    class_loss = obj_mask * sigmoid_bce(pred[..., 5:], target[..., 5:]).sum(
        dim=-1)

    def mean(x):  # per-image sum, batch mean
        return x.sum(dim=(1, 2, 3)).mean()

    losses = {"xy": LAMBDA_COORD * mean(xy_loss),
              "wh": LAMBDA_COORD * mean(wh_loss),
              "obj": mean(obj_loss),
              "noobj": LAMBDA_NOOBJ * mean(noobj_loss),
              "class": mean(class_loss)}
    losses["total"] = sum(losses.values())
    return losses


def yolo_loss_fn(outputs: Sequence[torch.Tensor], batch: dict,
                 anchors=YOLO_ANCHORS, anchor_masks=YOLO_ANCHOR_MASKS,
                 ignore_thresh: float = 0.5
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The three scales' losses summed; batch {'labels': per-scale
    targets, 'boxes': (B, N, 4) xywh}. Metrics: loss_<scale> for each
    scale, the large scale's <term>s, and loss."""
    anchors = torch.as_tensor(np.asarray(anchors),
                              dtype=outputs[0].dtype,
                              device=outputs[0].device)
    total = 0.0
    metrics = {}
    for i, (pred, target) in enumerate(zip(outputs, batch["labels"])):
        scale = anchors[torch.as_tensor(np.asarray(anchor_masks[i]))]
        losses = yolo_loss_per_scale(pred, target, batch["boxes"], scale,
                                     ignore_thresh)
        total = total + losses["total"]
        metrics[f"loss_{SCALE_NAMES[i]}"] = losses["total"]
        if i == 0:  # one scale's breakdown, as the reference logs it
            for k in ("xy", "wh", "obj", "noobj", "class"):
                metrics[f"{SCALE_NAMES[i]}_{k}"] = losses[k]
    metrics["loss"] = total
    return total, metrics


def yolo_train_loss_fn(outputs: Sequence[torch.Tensor], batch: dict,
                       grid_sizes: Sequence[int] = (13, 26, 52),
                       num_classes: int = 80, anchors=YOLO_ANCHORS,
                       anchor_masks=YOLO_ANCHOR_MASKS,
                       ignore_thresh: float = 0.5):
    """The YOLO loss with the targets assigned in the step from the
    batch's padded `boxes` (B, N, 4) xyxy normalized and `classes`
    (B, N)."""
    xywh = xyxy_to_xywh(batch["boxes"])
    labels = assign_anchors_to_grid(xywh, batch["classes"], grid_sizes,
                                    anchors, anchor_masks, num_classes)
    return yolo_loss_fn(outputs, {"labels": labels, "boxes": xywh},
                        anchors, anchor_masks, ignore_thresh)
