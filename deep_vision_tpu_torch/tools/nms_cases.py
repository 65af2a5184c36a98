"""Edge cases of greedy NMS selection, shared by the CPU model of the NMS
kernels (tests/test_torch_nms_tiles.py), the card tests
(tests/test_torch_cuda_kernels.py) and chip_smoke.py.

Each case is (label, boxes (B, N, 4) float32 xyxy, scores (B, N) float32,
max_detections, iou_threshold, score_threshold), drawn with numpy from a
fixed seed, small enough for the plain version on the CPU.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Case = Tuple[str, np.ndarray, np.ndarray, int, float, float]


def detections(seed: int, b: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Boxes of side 0.02-0.27 in the unit square and uniform scores."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2).astype(np.float32) * 0.8
    wh = rng.rand(b, n, 2).astype(np.float32) * 0.25 + 0.02
    return np.concatenate([xy, xy + wh], -1), rng.rand(b, n).astype(np.float32)


def clustered(seed: int, b: int, n: int,
              clusters: int) -> Tuple[np.ndarray, np.ndarray]:
    """Boxes jittered around `clusters` centres: each centre's boxes
    overlap (IoU > 0.3), so most candidates are suppressed. Scores fall
    with the centre's number, so the last centres' first boxes come late
    in the sorted order."""
    rng = np.random.RandomState(seed)
    centre = rng.rand(b, clusters, 2).astype(np.float32) * 0.8
    which = rng.randint(0, clusters, size=(b, n))
    xy = np.take_along_axis(centre, which[..., None], 1) + (
        rng.rand(b, n, 2).astype(np.float32) * 0.01)
    scores = rng.rand(b, n) * 0.1 + (1.0 - which / clusters) * 0.9
    return (np.concatenate([xy, xy + 0.1], -1).astype(np.float32),
            scores.astype(np.float32))


def edge_cases() -> List[Case]:
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    cases = []
    boxes, scores = detections(1, 2, 200)
    scores[0, [17, 40, 90]] = 2.0  # first index wins the tie...
    boxes[0, 40] = boxes[0, 17]    # ...and suppresses its duplicate
    cases.append(("ties on the top score", boxes, scores, 100, 0.5, 0.3))
    boxes, _ = detections(2, 2, 300)
    cases.append(("all-equal scores", boxes,
                  np.full((2, 300), 0.7, np.float32), 100, 0.5, 0.3))
    boxes, _ = detections(3, 2, 250)
    rng = np.random.RandomState(3)
    signed = rng.randn(2, 250).astype(np.float32)
    signed[:, ::7] = 0.0
    signed[1, ::11] = -0.0
    for thr in (0.0, -1.0):
        cases.append((f"score_threshold {thr} with zero and negative scores",
                      boxes, signed, 100, 0.5, thr))
    boxes, scores = detections(4, 2, 300)
    scores[0, ::5] = nan
    scores[1, scores[1].argmax()] = nan  # the best score is NaN
    cases.append(("NaN scores", boxes, scores, 100, 0.5, 0.3))
    boxes, scores = detections(5, 2, 200)
    # a kept pick with a NaN coordinate does not suppress its twin (IoU
    # NaN); fminf/fmaxf would clip it to 0.5 x 0.5 and suppress it
    boxes[0, 3] = [nan, 0.0, 0.5, 0.5]
    boxes[0, 4] = [0.0, 0.0, 0.5, 0.5]
    scores[0, 3], scores[0, 4] = 1.5, 1.4
    # a candidate with a NaN coordinate is never suppressed
    boxes[1, 8] = boxes[1, 9]
    boxes[1, 8, 2] = nan
    scores[1, 8], scores[1, 9] = 1.4, 1.5
    cases.append(("NaN coordinates on a kept pick and on a candidate",
                  boxes, scores, 100, 0.5, 0.3))
    boxes, scores = detections(6, 2, 240)
    boxes[:, 1::3] = boxes[:, 0::3]  # pairs of duplicates, other scores
    boxes[:, 2::3] = boxes[:, 0::3]
    scores[1, 2::3] = scores[1, 0::3]  # and equal scores on some
    cases.append(("duplicate boxes", boxes, scores, 100, 0.5, 0.3))
    boxes, scores = detections(7, 2, 200)
    scores[0, 5] = inf
    boxes[0, 6] = [0.1, 0.1, inf, 0.3]
    boxes[1, 7] = [-inf, 0.2, 0.4, 0.3]
    cases.append(("infinite scores and coordinates", boxes, scores, 100, 0.5,
                  0.3))
    boxes, scores = detections(8, 2, 150)
    boxes[0, 10] = boxes[0, 11]
    for iou in (0.0, 1.0):
        cases.append((f"iou_threshold {iou}", boxes, scores, 100, iou, 0.3))
    boxes, scores = detections(9, 2, 300)
    cases.append(("D > M", boxes, scores * 0.35, 100, 0.5, 0.3))
    cases.append(("M = 0", boxes, scores * 0.25, 100, 0.5, 0.3))
    boxes, scores = detections(10, 3, 77)
    cases.append(("N = 77, not a multiple of 64", boxes, scores, 30, 0.5,
                  0.3))
    boxes, scores = detections(11, 2, 1001)
    cases.append(("N = 1001, D = 300", boxes, scores, 300, 0.5, 0.1))
    boxes, scores = clustered(21, 2, 900, 30)
    cases.append(("900 boxes in 30 clusters, D = 24", boxes, scores, 24, 0.3,
                  0.05))
    return cases


def large_cases() -> List[Case]:
    """More candidates than one pass takes (M > K = 4096), for the card."""
    boxes, scores = detections(12, 2, 70_000)
    cases = [("N = 70000, score_threshold 0.0 (M > K)", boxes, scores, 100,
              0.5, 0.0)]
    boxes, scores = clustered(13, 2, 70_000, 120)
    cases.append(("N = 70000 in 120 clusters (D keeps after many passes)",
                  boxes, scores, 100, 0.3, 0.0))
    return cases
