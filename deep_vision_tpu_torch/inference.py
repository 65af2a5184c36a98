"""YOLO prediction path: images -> NMS'd detections
(deep_vision_tpu/inference.py:68-165, the YOLO part).

`yolo_predict_fn(model)` returns the raw `(variables, images) -> dict`
function that the serving Engine runs per bucket. Variables stay a
runtime argument (`torch.func.functional_call` over the model's
state_dict), which is what a weight hot-swap relies on: new variables of
the same shapes take effect at the next call, with nothing rebuilt.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from deep_vision_tpu_torch.core.backend import (
    DeviceLike,
    resolve_device,
    synchronize,
)
from deep_vision_tpu_torch.obs.registry import get_registry
from deep_vision_tpu_torch.ops.anchors import YOLO_ANCHOR_MASKS, YOLO_ANCHORS
from deep_vision_tpu_torch.ops.boxes import decode_yolo_boxes
from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms
from deep_vision_tpu_torch.ops.nms import non_maximum_suppression


def yolo_decode_outputs(outputs: Sequence[torch.Tensor],
                        anchors=YOLO_ANCHORS,
                        anchor_masks=YOLO_ANCHOR_MASKS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw 3-scale head outputs -> flat (B, N, 4) xyxy boxes and (B, N, C)
    scores = objectness x class probability."""
    anchors = torch.as_tensor(np.asarray(anchors), dtype=outputs[0].dtype,
                              device=outputs[0].device)
    all_boxes, all_scores = [], []
    for pred, mask in zip(outputs, anchor_masks):
        boxes, obj, cls = decode_yolo_boxes(
            pred, anchors[torch.as_tensor(np.asarray(mask))])
        b = boxes.shape[0]
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_scores.append((obj * cls).reshape(b, -1, cls.shape[-1]))
    return torch.cat(all_boxes, 1), torch.cat(all_scores, 1)


@torch.inference_mode()
def yolo_detect(
    variables: Dict[str, torch.Tensor],
    images: torch.Tensor,
    *,
    model: torch.nn.Module,
    anchors=YOLO_ANCHORS,
    anchor_masks=YOLO_ANCHOR_MASKS,
    max_detections: int = 100,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.5,
    select: Callable = greedy_nms,
) -> Dict[str, torch.Tensor]:
    """images (B, H, W, 3) in [0, 1] -> dict of boxes (B, D, 4) xyxy
    normalized, scores (B, D), classes (B, D) int32 (-1 = padding),
    num (B,) int32."""
    outputs = functional_call(model, variables, (images,))
    boxes, scores = yolo_decode_outputs(outputs, anchors, anchor_masks)
    # best class per candidate; NMS is class-aware via the offset trick
    best_score, best_class = scores.max(dim=-1)
    out_b, out_s, out_c, valid = non_maximum_suppression(
        boxes, best_score, best_class.to(torch.int32),
        max_detections=max_detections, iou_threshold=iou_threshold,
        score_threshold=score_threshold, select=select)
    return {"boxes": out_b, "scores": out_s, "classes": out_c, "num": valid}


def yolo_predict_fn(model: torch.nn.Module, **kwargs) -> Callable:
    """The raw (variables, images) -> detections fn; keyword arguments are
    yolo_detect's (anchors, thresholds, max_detections, select)."""
    return functools.partial(yolo_detect, model=model, **kwargs)


def make_yolo_detector(model: torch.nn.Module, *, device: DeviceLike = None,
                       registry=None, **kwargs) -> Callable:
    """A (variables, images) -> detections callable on `device` (default
    cuda) that moves the images there, waits for the result, and records
    each call's latency in `inference_latency_ms{task="yolo"}`."""
    dev = resolve_device(device)
    model.to(dev)
    fn = yolo_predict_fn(model, **kwargs)
    reg = registry or get_registry()
    hist = reg.histogram("inference_latency_ms",
                         "per-request predictor latency, fenced",
                         labels={"task": "yolo"})
    count = reg.counter("inference_requests_total", "predictor calls",
                        labels={"task": "yolo"})

    def detect(variables, images):
        t0 = time.perf_counter()
        out = fn(variables, torch.as_tensor(images, device=dev))
        synchronize(dev)
        hist.observe((time.perf_counter() - t0) * 1e3)
        count.inc()
        return out

    return detect
