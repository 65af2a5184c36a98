"""Box transforms, broadcast IoU and YOLO box decode and encode
(deep_vision_tpu/ops/boxes.py).

Conventions as in the reference: boxes are (..., 4); 'xywh' = center x,
center y, width, height; 'xyxy' = x1, y1, x2, y2; normalized to [0, 1].
"""
from __future__ import annotations

from typing import Tuple

import torch


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    xy, wh = boxes[..., :2], boxes[..., 2:4]
    return torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    mins, maxs = boxes[..., :2], boxes[..., 2:4]
    return torch.cat([(mins + maxs) / 2.0, maxs - mins], dim=-1)


def broadcast_iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) vs (..., M, 4) xyxy boxes -> (..., N, M); sides
    clipped at 0, union floored at 1e-9."""
    a = box_a[..., :, None, :]
    b = box_b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0.0)
              * (a[..., 3] - a[..., 1]).clamp(min=0.0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0.0)
              * (b[..., 3] - b[..., 1]).clamp(min=0.0))
    union = area_a + area_b - inter
    return inter / union.clamp(min=1e-9)


def _grid_offsets(gy: int, gx: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """(gy, gx, 1, 2) cell top-left offsets (x, y)."""
    ys = torch.arange(gy, dtype=dtype, device=device)
    xs = torch.arange(gx, dtype=dtype, device=device)
    gy_grid, gx_grid = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx_grid, gy_grid], dim=-1)[:, :, None, :]


def decode_yolo_boxes(pred: torch.Tensor, anchors: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw head output (B, g, g, A, 5+C), anchors (A, 2) normalized w, h
    -> (boxes_xyxy (B,g,g,A,4), objectness (B,g,g,A,1), class_probs).
    bx = (sigmoid(tx) + cx) / g ; bw = pw * exp(clip(tw, -10, 10))."""
    _, gy, gx, _, _ = pred.shape
    t_xy = pred[..., 0:2]
    t_wh = pred[..., 2:4]
    objectness = torch.sigmoid(pred[..., 4:5])
    class_probs = torch.sigmoid(pred[..., 5:])
    grid = _grid_offsets(gy, gx, pred.dtype, pred.device)
    scale = torch.tensor([gx, gy], dtype=pred.dtype, device=pred.device)
    b_xy = (torch.sigmoid(t_xy) + grid) / scale
    b_wh = torch.exp(t_wh.clamp(-10.0, 10.0)) * anchors
    boxes = xywh_to_xyxy(torch.cat([b_xy, b_wh], dim=-1))
    return boxes, objectness, class_probs


def encode_yolo_boxes(boxes_xywh: torch.Tensor, anchors: torch.Tensor,
                      grid_size: int) -> torch.Tensor:
    """Absolute xywh -> the (tx, ty, tw, th) regression targets, the
    inverse of the decode: tx = x * g - floor(x * g), tw = log(w / pw),
    with w and pw floored at 1e-9 and tw, th = 0 where w or h is 0
    (padding)."""
    b_xy, b_wh = boxes_xywh[..., :2], boxes_xywh[..., 2:4]
    scaled = b_xy * grid_size
    t_xy = scaled - torch.floor(scaled)
    t_wh = torch.log(b_wh.clamp(min=1e-9) / anchors.clamp(min=1e-9))
    valid = (b_wh[..., 0] > 0) & (b_wh[..., 1] > 0)
    t_wh = torch.where(valid[..., None], t_wh, 0.0)
    return torch.cat([t_xy, t_wh], dim=-1)
