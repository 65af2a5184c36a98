"""Host-side training-label generators for dense-prediction tasks.

Parity targets:
- Pose heatmaps: `generate_2d_guassian`/`make_heatmaps`
  (Hourglass/tensorflow/preprocess.py:91-173) — 64x64xK gaussian heatmaps
  from normalized keypoints, visibility-aware, 7x7 patch semantics
  generalized to a full vectorized gaussian.
- CenterNet targets: COMPLETED here — the reference's label generation
  early-returns zeros (ObjectsAsPoints/tensorflow/preprocess.py:129-147,
  SURVEY.md §2.9). Implemented from the ObjectsAsPoints paper: per-class
  center gaussians with IoU-derived radius, wh + sub-pixel offset at centers.

A copy of deep_vision_tpu/data/labels.py. Numpy on purpose: these run
in DataLoader worker threads.
"""
from __future__ import annotations

import numpy as np


def gaussian_2d(height: int, width: int, cx: float, cy: float, sigma: float):
    """Dense 2-D gaussian peaked at (cx, cy), grid coords."""
    ys = np.arange(height, dtype=np.float32)[:, None]
    xs = np.arange(width, dtype=np.float32)[None, :]
    return np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma ** 2))


def make_pose_heatmaps(sample: dict, size: int = 64, sigma: float = 1.0,
                       num_joints: int = 16) -> dict:
    """Add 'heatmap' (size, size, J) from normalized 'keypoints' (J, 2) +
    'visibility' (J,). Invisible joints get all-zero maps
    (visibility-aware scatter, Hourglass/tensorflow/preprocess.py:158-173)."""
    kp = np.asarray(sample["keypoints"], np.float32)
    vis = np.asarray(
        sample.get("visibility", np.ones((len(kp),), np.float32)), np.float32
    )
    hm = np.zeros((size, size, num_joints), np.float32)
    for j in range(min(num_joints, len(kp))):
        x, y = kp[j]
        if vis[j] <= 0 or not (0.0 <= x <= 1.0 and 0.0 <= y <= 1.0):
            continue
        hm[:, :, j] = gaussian_2d(size, size, x * (size - 1), y * (size - 1), sigma)
    sample["heatmap"] = hm
    return sample


def centernet_radius(h: float, w: float, min_overlap: float = 0.7) -> float:
    """Gaussian radius such that corners shifted by r keep IoU >= min_overlap
    (CornerNet derivation used by ObjectsAsPoints)."""
    a1, b1 = 1.0, h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - np.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0.0))) / 2
    a2, b2 = 4.0, 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - np.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0.0))) / 2
    a3, b3 = 4 * min_overlap, -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + np.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0.0))) / (2 * a3)
    return max(0.0, min(r1, r2, r3))


def make_centernet_targets(sample: dict, out_size: int = 128,
                           num_classes: int = 80) -> dict:
    """Add 'heatmap' (S,S,C), 'wh' (S,S,2), 'offset' (S,S,2), 'mask' (S,S)
    from normalized x1y1x2y2 'boxes' + 'classes' (padded rows all-zero)."""
    boxes = np.asarray(sample.get("boxes", ()), np.float32).reshape(-1, 4)
    classes = np.asarray(sample.get("classes", ()), np.int32).reshape(-1)
    S = out_size
    hm = np.zeros((S, S, num_classes), np.float32)
    wh = np.zeros((S, S, 2), np.float32)
    off = np.zeros((S, S, 2), np.float32)
    mask = np.zeros((S, S), np.float32)
    for i, b in enumerate(boxes):
        w, h = (b[2] - b[0]) * S, (b[3] - b[1]) * S
        if w <= 0 or h <= 0:
            continue
        cx, cy = (b[0] + b[2]) / 2 * S, (b[1] + b[3]) / 2 * S
        ix, iy = min(int(cx), S - 1), min(int(cy), S - 1)
        r = max(centernet_radius(h, w), 1.0)
        cls = int(classes[i]) if i < len(classes) else 0
        g = gaussian_2d(S, S, cx, cy, r / 3.0)
        hm[:, :, cls] = np.maximum(hm[:, :, cls], g)
        wh[iy, ix] = (w, h)
        off[iy, ix] = (cx - ix, cy - iy)
        mask[iy, ix] = 1.0
    sample["heatmap"] = hm
    sample["wh"] = wh
    sample["offset"] = off
    sample["mask"] = mask
    return sample


class MakePoseHeatmaps:
    def __init__(self, size: int = 64, sigma: float = 1.0, num_joints: int = 16):
        self.kw = dict(size=size, sigma=sigma, num_joints=num_joints)

    def __call__(self, sample: dict, rng) -> dict:
        return make_pose_heatmaps(sample, **self.kw)


class MakeCenternetTargets:
    def __init__(self, out_size: int = 128, num_classes: int = 80):
        self.kw = dict(out_size=out_size, num_classes=num_classes)

    def __call__(self, sample: dict, rng) -> dict:
        return make_centernet_targets(sample, **self.kw)
