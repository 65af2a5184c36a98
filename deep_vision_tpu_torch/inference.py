"""Prediction paths: YOLO images -> NMS'd detections, CenterNet's peak
decode and the pose argmax (deep_vision_tpu/inference.py:68-272).

`yolo_predict_fn(model)`, `centernet_predict_fn(model)` and
`pose_predict_fn(model)` return the raw `(variables, images) -> output`
functions; `make_yolo_detector`, `make_centernet_detector` and
`make_pose_estimator` wrap them for a device, fenced and timed into
`inference_latency_ms{task=...}`. Variables stay a runtime argument
(`torch.func.functional_call` over the model's state_dict), which is
what a weight hot-swap relies on: new variables of the same shapes take
effect at the next call, with nothing rebuilt.

CenterNet's decode keeps two of JAX's rules: `reduce_window`'s SAME
padding is -inf (a peak equals the max of its 3x3 window, edges
included), and `lax.top_k` returns equal scores lowest index first,
which `torch.topk` does not promise: the top k come from a stable
descending sort. The pose argmax takes the first maximum, as
`jnp.argmax` does.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
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


def _observed(fn: Callable, task: str, dev: torch.device,
              registry=None) -> Callable:
    """fn on `dev`: moves the images there, waits for the result, and
    records each call's latency in `inference_latency_ms{task=...}`."""
    reg = registry or get_registry()
    hist = reg.histogram("inference_latency_ms",
                         "per-request predictor latency, fenced",
                         labels={"task": task})
    count = reg.counter("inference_requests_total", "predictor calls",
                        labels={"task": task})

    def call(variables, images):
        t0 = time.perf_counter()
        out = fn(variables, torch.as_tensor(images, device=dev))
        synchronize(dev)
        hist.observe((time.perf_counter() - t0) * 1e3)
        count.inc()
        return out

    return call


def make_yolo_detector(model: torch.nn.Module, *, device: DeviceLike = None,
                       registry=None, **kwargs) -> Callable:
    """A (variables, images) -> detections callable on `device` (default
    cuda), observed as task "yolo"."""
    dev = resolve_device(device)
    model.to(dev)
    return _observed(yolo_predict_fn(model, **kwargs), "yolo", dev,
                     registry)


def top_k_lowest_index_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, equal values
    lowest index first, as lax.top_k orders them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.inference_mode()
def centernet_decode(head: Dict[str, torch.Tensor], *,
                     max_detections: int = 100,
                     score_threshold: float = 0.1) -> Dict[str, torch.Tensor]:
    """A CenterNet head dict (NHWC raw 'heatmap', 'wh', 'offset') ->
    detections: a cell whose sigmoid score equals the max of its 3x3
    window is a peak, the top `max_detections` peaks over (cell, class)
    become boxes from the wh and offset branches. -> boxes (B, D, 4) xyxy
    normalised, scores (B, D), classes (B, D) int32 (-1 below the
    threshold), num (B,) int32."""
    heatmap = torch.sigmoid(head["heatmap"])
    b, h, w, c = heatmap.shape
    pooled = F.max_pool2d(heatmap.permute(0, 3, 1, 2), 3, 1, padding=1)
    peaks = torch.where(pooled.permute(0, 2, 3, 1) == heatmap, heatmap, 0.0)
    flat = peaks.reshape(b, -1)  # index = (y * w + x) * c + class
    k = min(max_detections, flat.shape[-1])
    scores, idx = top_k_lowest_index_first(flat, k)
    if k < max_detections:  # keep the (B, max_detections) contract
        scores = F.pad(scores, (0, max_detections - k))
        idx = F.pad(idx, (0, max_detections - k))
    cls = (idx % c).to(torch.int32)
    spatial = idx // c
    ys = (spatial // w).to(torch.float32)
    xs = (spatial % w).to(torch.float32)

    def gather_spatial(branch):  # (B, h, w, 2) -> (B, k, 2) at the peaks
        flat_b = branch.reshape(b, -1, branch.shape[-1])
        return torch.gather(flat_b, 1, spatial[..., None].expand(
            -1, -1, branch.shape[-1]))

    off = gather_spatial(head["offset"])
    wh = gather_spatial(head["wh"])
    cx = (xs + off[..., 0]) / w
    cy = (ys + off[..., 1]) / h
    bw = wh[..., 0] / w
    bh = wh[..., 1] / h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2], -1)
    keep = scores >= score_threshold
    return {"boxes": torch.where(keep[..., None], boxes, 0.0),
            "scores": torch.where(keep, scores, 0.0),
            "classes": torch.where(keep, cls, -1).to(torch.int32),
            "num": keep.sum(-1).to(torch.int32)}


def centernet_predict_fn(model: torch.nn.Module, *, max_detections: int = 100,
                         score_threshold: float = 0.1) -> Callable:
    """The raw (variables, images) -> detections fn: the model in eval
    mode, the last stack's head decoded."""
    @torch.inference_mode()
    def detect(variables, images):
        outputs = functional_call(model, variables, (images,))
        return centernet_decode(outputs[-1], max_detections=max_detections,
                                score_threshold=score_threshold)

    return detect


def make_centernet_detector(model: torch.nn.Module, *,
                            device: DeviceLike = None, registry=None,
                            **kwargs) -> Callable:
    """A (variables, images) -> detections callable on `device` (default
    cuda), observed as task "centernet"."""
    dev = resolve_device(device)
    model.to(dev)
    return _observed(centernet_predict_fn(model, **kwargs), "centernet",
                     dev, registry)


def heatmaps_to_keypoints(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, h, w, J) heatmaps -> (B, J, 3) normalised (x, y, score) at
    each joint's first maximum."""
    b, h, w, j = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(b, j, -1)
    idx = flat.argmax(dim=-1)
    score = flat.amax(dim=-1)
    ys = (idx // w).to(torch.float32) / h
    xs = (idx % w).to(torch.float32) / w
    return torch.stack([xs, ys, score], dim=-1)


def pose_predict_fn(model: torch.nn.Module) -> Callable:
    """The raw (variables, images) -> (B, J, 3) keypoints fn, from the
    last stack's heatmaps."""
    @torch.inference_mode()
    def estimate(variables, images):
        outputs = functional_call(model, variables, (images,))
        heatmaps = (outputs[-1] if isinstance(outputs, (list, tuple))
                    else outputs)
        return heatmaps_to_keypoints(heatmaps)

    return estimate


def make_pose_estimator(model: torch.nn.Module, *, device: DeviceLike = None,
                        registry=None) -> Callable:
    """A (variables, images) -> keypoints callable on `device` (default
    cuda), observed as task "pose"."""
    dev = resolve_device(device)
    model.to(dev)
    return _observed(pose_predict_fn(model), "pose", dev, registry)
