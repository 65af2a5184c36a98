"""Fixed-shape, class-aware greedy NMS (deep_vision_tpu/ops/nms.py:77-128).

The class-offset trick translates every box by 2 x its class, so boxes of
different classes never overlap and one selection pass serves all
classes; then the picks are gathered back. The selection is
`ops/cuda/nms.py greedy_nms`: the CUDA kernel for a CUDA tensor, its
plain version for a CPU tensor. No environment switch chooses between
them.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms


def non_maximum_suppression(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: Optional[torch.Tensor] = None,
    max_detections: int = 100,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.5,
    select: Callable = greedy_nms,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """boxes (B, N, 4) xyxy in [0, 1]; scores (B, N); classes (B, N) int or
    None. Returns (boxes (B, D, 4), scores (B, D), classes (B, D) int32,
    valid (B,) int32), D = max_detections; padded entries have score 0,
    class -1 and a zero box. `select` is the selection function; a check
    that holds the kernel against its plain version on the card passes
    `nms_plain` here."""
    if classes is None:
        classes = torch.zeros(scores.shape, dtype=torch.int32,
                              device=scores.device)
    shifted = boxes + classes.to(boxes.dtype)[..., None] * 2.0
    sel_s, sel_i = select(shifted.float().contiguous(),
                          scores.float().contiguous(), max_detections,
                          iou_threshold, score_threshold)
    picked = sel_i >= 0
    safe = sel_i.clamp(min=0).long()
    out_classes = torch.where(
        picked, torch.gather(classes, 1, safe).to(torch.int32), -1)
    out_boxes = torch.where(
        picked[..., None],
        torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4)), 0.0)
    valid = picked.sum(dim=-1, dtype=torch.int32)
    return out_boxes, sel_s.to(scores.dtype), out_classes, valid
