"""Detection mAP, VOC and COCO style, the port of
deep_vision_tpu/core/detection_metrics.py:20-135 (numpy only, on the
host, over a whole eval pass), and the pose metrics `pck` and `pckh`
(:137-173).

Inputs follow the predictor's output convention (inference.py): padded
fixed-size arrays, with class -1 or score 0 marking padding; padded
ground-truth rows are all-zero boxes.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _average_precision(recall: np.ndarray, precision: np.ndarray,
                       interpolation: str) -> float:
    if interpolation == "11point":
        # VOC2007 11-point interpolation
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    # all-point (VOC2010+/COCO style): area under the monotone precision envelope
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    changed = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changed + 1] - mrec[changed]) * mpre[changed + 1]))


class DetectionEvaluator:
    """Accumulates per-image detections + ground truth, computes mAP.

    Usage:
        ev = DetectionEvaluator(num_classes)
        for each image: ev.add(pred_boxes, pred_scores, pred_classes,
                               gt_boxes, gt_classes)
        result = ev.compute(iou_threshold=0.5)  # {'mAP': ..., 'ap_per_class': ...}
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        # per class: list of (score, image_id, box)
        self._dets: Dict[int, List] = defaultdict(list)
        # per (class, image_id): gt boxes
        self._gts: Dict[tuple, List] = defaultdict(list)
        self._n_images = 0

    def add(self, pred_boxes, pred_scores, pred_classes,
            gt_boxes, gt_classes) -> None:
        """One image. Padded preds (class < 0 or score <= 0) and padded GT
        rows (all-zero boxes) are dropped here."""
        img = self._n_images
        self._n_images += 1
        pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 4)
        pred_scores = np.asarray(pred_scores, np.float32).reshape(-1)
        pred_classes = np.asarray(pred_classes).reshape(-1)
        keep = (pred_classes >= 0) & (pred_scores > 0)
        for b, s, c in zip(pred_boxes[keep], pred_scores[keep], pred_classes[keep]):
            self._dets[int(c)].append((float(s), img, b))
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes).reshape(-1)
        gt_keep = np.any(gt_boxes != 0, axis=-1)
        for b, c in zip(gt_boxes[gt_keep], gt_classes[gt_keep]):
            self._gts[(int(c), img)].append(b)

    def compute(self, iou_threshold: float = 0.5,
                interpolation: str = "all") -> Dict:
        """Greedy score-ordered matching per class (the standard VOC protocol)."""
        ap_per_class = {}
        for c in range(self.num_classes):
            n_gt = sum(
                len(v) for (cc, _), v in self._gts.items() if cc == c
            )
            dets = sorted(self._dets.get(c, []), key=lambda t: -t[0])
            if n_gt == 0:
                # VOC/COCO protocol: classes absent from the ground truth are
                # excluded from the mean (their FPs are not scoreable)
                continue
            matched: Dict[int, np.ndarray] = {}
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, (_, img, box) in enumerate(dets):
                gts = self._gts.get((c, img), [])
                if not gts:
                    fp[i] = 1
                    continue
                gt_arr = np.stack(gts)
                used = matched.setdefault(img, np.zeros(len(gts), bool))
                ious = _iou_matrix(box[None], gt_arr)[0]
                best = int(np.argmax(ious))
                if ious[best] >= iou_threshold and not used[best]:
                    tp[i] = 1
                    used[best] = True
                else:
                    fp[i] = 1
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            recall = ctp / n_gt
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            ap_per_class[c] = _average_precision(recall, precision, interpolation)
        aps = list(ap_per_class.values())
        return {
            "mAP": float(np.mean(aps)) if aps else 0.0,
            "ap_per_class": ap_per_class,
            "num_images": self._n_images,
        }

    def compute_coco(self) -> Dict:
        """COCO headline metric: mAP averaged over IoU .5:.05:.95."""
        aps = [
            self.compute(iou_threshold=t)["mAP"]
            for t in np.arange(0.5, 1.0, 0.05)
        ]
        return {"mAP@[.5:.95]": float(np.mean(aps)), "mAP@.5": aps[0]}


def pck(pred_kpts, gt_kpts, visible, norm_lengths,
        alpha: float = 0.5) -> Dict:
    """PCK (detection_metrics.py:137-167): the share of visible keypoints
    within alpha * norm of the ground truth. pred/gt (N, J, 2+), visible
    (N, J) boolean, norm_lengths (N,) (the head segment for MPII's PCKh).
    -> {f"PCK@{alpha}", "per_joint", "num_visible"}."""
    pred = np.asarray(pred_kpts, np.float32)[..., :2]
    gt = np.asarray(gt_kpts, np.float32)[..., :2]
    vis = np.asarray(visible, bool)
    norm = np.asarray(norm_lengths, np.float32).reshape(-1, 1)
    dist = np.linalg.norm(pred - gt, axis=-1)  # (N, J)
    correct = (dist <= alpha * np.maximum(norm, 1e-9)) & vis
    total = vis.sum()
    per_joint = []
    for j in range(gt.shape[1]):
        vj = vis[:, j].sum()
        per_joint.append(float(correct[:, j].sum() / vj) if vj
                         else float("nan"))
    return {f"PCK@{alpha}": float(correct.sum() / total) if total else 0.0,
            "per_joint": per_joint, "num_visible": int(total)}


def pckh(pred_kpts, gt_kpts, visible, head_sizes,
         alpha: float = 0.5) -> Dict:
    """MPII PCKh: PCK normalised by the head segment length."""
    out = pck(pred_kpts, gt_kpts, visible, head_sizes, alpha)
    out[f"PCKh@{alpha}"] = out.pop(f"PCK@{alpha}")
    return out
