"""Port parity: deep_vision_tpu_torch/core/detection_metrics.py
`DetectionEvaluator` (VOC-style AP at one IoU, all-point and 11-point,
and COCO's mAP over .5:.95) against the JAX package's numpy original, on
seeded detections: jittered copies of the ground truth, false positives,
padding rows (class -1, score 0, all-zero boxes) and classes without
ground truth. Both are numpy over the same inputs in the same order, so
every number must be equal.
"""
import numpy as np
import pytest

from deep_vision_tpu.core.detection_metrics import (
    DetectionEvaluator as RefEvaluator,
)
from deep_vision_tpu_torch.core.detection_metrics import DetectionEvaluator

NUM_CLASSES = 5


def seeded_images(seed, n_images=12, max_det=20, max_gt=6):
    rng = np.random.RandomState(seed)
    for _ in range(n_images):
        n_gt = rng.randint(0, max_gt + 1)
        xy = rng.uniform(0.0, 0.7, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (n_gt, 2))], 1)
        gt_cls = rng.randint(0, NUM_CLASSES - 1, n_gt)  # the last: none
        gt_boxes = np.zeros((max_gt + 2, 4), np.float32)
        gt_classes = np.zeros(max_gt + 2, np.int32)
        gt_boxes[:n_gt], gt_classes[:n_gt] = gt, gt_cls
        # detections: jittered ground truth, then random boxes, then pads
        hit = gt + rng.normal(0.0, 0.02, gt.shape)
        n_fp = rng.randint(0, 5)
        fxy = rng.uniform(0.0, 0.7, (n_fp, 2))
        fp = np.concatenate([fxy, fxy + rng.uniform(0.05, 0.3, (n_fp, 2))],
                            1)
        det = np.concatenate([hit, fp])[:max_det]
        boxes = np.zeros((max_det, 4), np.float32)
        scores = np.zeros(max_det, np.float32)
        classes = np.full(max_det, -1, np.int32)
        k = len(det)
        boxes[:k] = det
        scores[:k] = rng.uniform(0.1, 1.0, k)
        classes[:k] = np.concatenate([gt_cls, rng.randint(
            0, NUM_CLASSES, n_fp)])[:k]
        yield boxes, scores, classes, gt_boxes, gt_classes


def both(seed):
    port, ref = DetectionEvaluator(NUM_CLASSES), RefEvaluator(NUM_CLASSES)
    for image in seeded_images(seed):
        port.add(*image)
        ref.add(*image)
    return port, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou,interpolation", [
    (0.5, "all"), (0.75, "all"), (0.5, "11point")])
def test_map_equals_the_reference(seed, iou, interpolation):
    port, ref = both(seed)
    got = port.compute(iou_threshold=iou, interpolation=interpolation)
    want = ref.compute(iou_threshold=iou, interpolation=interpolation)
    assert got == want
    assert NUM_CLASSES - 1 not in got["ap_per_class"]  # no ground truth
    assert got["num_images"] == 12 and 0.0 < got["mAP"] <= 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_coco_map_equals_the_reference(seed):
    port, ref = both(seed)
    got, want = port.compute_coco(), ref.compute_coco()
    assert got == want
    assert got["mAP@[.5:.95]"] <= got["mAP@.5"]


def test_perfect_and_empty_evaluations():
    ev = DetectionEvaluator(2)
    gt = np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.8]], np.float32)
    ev.add(gt, [0.9, 0.8], [0, 1], gt, [0, 1])
    assert ev.compute()["mAP"] == 1.0
    assert ev.compute_coco()["mAP@[.5:.95]"] == 1.0
    empty = DetectionEvaluator(3)
    empty.add(np.zeros((4, 4)), np.zeros(4), -np.ones(4), np.zeros((2, 4)),
              np.zeros(2))
    assert empty.compute() == {"mAP": 0.0, "ap_per_class": {},
                               "num_images": 1}
