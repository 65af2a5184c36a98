"""YOLO anchors and the assignment of padded ground-truth boxes to the
per-scale target grids (deep_vision_tpu/ops/anchors.py).

Each valid box (w > 0 and h > 0) picks the best of the 9 anchors by the
IoU of their shapes (both centred at the origin); the scale that owns
that anchor writes `[x, y, w, h, 1, one-hot class]` into the cell
floor(xy * g), clipped to the grid, at the anchor's slot. Boxes whose
anchor another scale owns, and padded rows, write nothing.

Two boxes can land on the same (cell, slot). The reference writes with
`.at[].set`, where the last write wins on the CPU (the box with the
highest index). A CUDA `index_put_` with duplicate indices has no
defined winner, so the writer is chosen first: the highest box index
per (cell, slot), by a `scatter_reduce` max, and then every target is
written once.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

# COCO anchors normalized by 416; rows: (w, h)
YOLO_ANCHORS = np.array(
    [(10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
     (116, 90), (156, 198), (373, 326)],
    np.float32,
) / 416.0
# scale 0 = stride 32 (large objects) gets anchors 6,7,8, etc.
YOLO_ANCHOR_MASKS = np.array([[6, 7, 8], [3, 4, 5], [0, 1, 2]])


def _anchor_iou(wh: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """IoU of box shapes (..., N, 2) against anchors (A, 2) -> (..., N, A)."""
    inter = (torch.minimum(wh[..., None, 0], anchors[:, 0])
             * torch.minimum(wh[..., None, 1], anchors[:, 1]))
    area_box = wh[..., 0] * wh[..., 1]
    area_anchor = anchors[:, 0] * anchors[:, 1]
    return inter / (area_box[..., None] + area_anchor - inter).clamp(min=1e-9)


def assign_anchors_to_grid(boxes_xywh: torch.Tensor, classes: torch.Tensor,
                           grid_sizes: Sequence[int], anchors=YOLO_ANCHORS,
                           anchor_masks=YOLO_ANCHOR_MASKS,
                           num_classes: int = 80) -> List[torch.Tensor]:
    """Per-scale YOLO targets from padded boxes.

    boxes_xywh: (B, N, 4) normalized, padded rows with w == 0 or h == 0;
    classes: (B, N) ints (an id outside [0, num_classes) gets an all-zero
    one-hot, as jax.nn.one_hot gives). Returns a list over scales of
    (B, g, g, A, 5 + num_classes) targets laid out [x, y, w, h, obj,
    one-hot]."""
    dev, dt = boxes_xywh.device, boxes_xywh.dtype
    anchors = torch.as_tensor(np.asarray(anchors), dtype=dt, device=dev)
    masks = torch.as_tensor(np.asarray(anchor_masks), device=dev)
    b, n, _ = boxes_xywh.shape
    valid = (boxes_xywh[..., 2] > 0) & (boxes_xywh[..., 3] > 0)
    best = _anchor_iou(boxes_xywh[..., 2:4], anchors).argmax(dim=-1)
    onehot = (classes[..., None].long()
              == torch.arange(num_classes, device=dev)).to(dt)
    value = torch.cat([boxes_xywh, torch.ones_like(boxes_xywh[..., :1]),
                       onehot], dim=-1)  # (B, N, 5 + C)
    box_index = torch.arange(n, device=dev).expand(b, n)
    image = torch.arange(b, device=dev)[:, None].expand(b, n)
    targets = []
    for mask, g in zip(masks, grid_sizes):
        hit = best[..., None] == mask  # (B, N, A)
        owned = hit.any(dim=-1) & valid
        slot = hit.int().argmax(dim=-1)
        cell = torch.floor(boxes_xywh[..., :2] * g).long().clamp(0, g - 1)
        a = mask.shape[0]
        flat = ((image * g + cell[..., 1]) * g + cell[..., 0]) * a + slot
        # the writer of each (image, cell, slot): the highest box index
        flat, box = flat[owned], box_index[owned]
        winner = torch.full((b * g * g * a,), -1, dtype=box.dtype,
                            device=dev).scatter_reduce_(0, flat, box, "amax")
        writes = winner[flat] == box
        grid = torch.zeros(b * g * g * a, 5 + num_classes, dtype=dt,
                           device=dev)
        grid[flat[writes]] = value[owned][writes]
        targets.append(grid.view(b, g, g, a, 5 + num_classes))
    return targets
