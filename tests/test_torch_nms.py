"""Port parity: the plain NMS of deep_vision_tpu_torch/ops/cuda/nms.py and
the class-aware `non_maximum_suppression` against the JAX lax path and
`pallas_nms` in interpret mode.

Exact equality everywhere: every step is an IEEE float32 operation
(max, min, subtract, multiply, add, divide, compare) in the same order on
both sides, and selection is by exact comparison, so indices, scores,
classes and boxes must agree bit for bit.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.ops.nms import non_maximum_suppression as jax_nms
from deep_vision_tpu.ops.pallas.nms import pallas_nms
from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms, nms_plain
from deep_vision_tpu_torch.ops.nms import non_maximum_suppression


def detections(seed, b=2, n=256, n_classes=6):
    """The case shapes of tests/test_perf_fused.py::_detections."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2).astype(np.float32) * 0.8
    wh = rng.rand(b, n, 2).astype(np.float32) * 0.25 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.rand(b, n).astype(np.float32)
    classes = rng.randint(0, n_classes, size=(b, n)).astype(np.int32)
    return boxes, scores, classes


def special_cases():
    """Ties on the top score, an image whose scores are all below
    threshold, and an N that is a multiple of neither 32 nor 128."""
    boxes, scores, classes = detections(7, b=3, n=77)
    scores[0, [5, 20, 61]] = 2.0  # three-way tie above all: first index wins
    boxes[0, 20] = boxes[0, 5]     # and a duplicate box among them
    scores[1] = scores[1] * 0.25   # all below 0.3
    return boxes, scores, classes


def run_port(boxes, scores, classes, **kw):
    out = non_maximum_suppression(torch.from_numpy(boxes),
                                  torch.from_numpy(scores),
                                  torch.from_numpy(classes), **kw)
    return [o.numpy() for o in out]


def run_jax(boxes, scores, classes, impl, **kw):
    out = jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                  jnp.asarray(classes), impl=impl, **kw)
    return [np.asarray(o) for o in out]


def assert_same(got, want, label):
    for g, w, name in zip(got, want, ("boxes", "scores", "classes", "valid")):
        assert g.shape == w.shape, f"{label}: {name} shape"
        np.testing.assert_array_equal(g, w.astype(g.dtype),
                                      err_msg=f"{label}: {name}")


KW = dict(max_detections=25, iou_threshold=0.5, score_threshold=0.3)


@pytest.mark.parametrize("impl", ["lax", "pallas"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_aware_nms_matches_reference(seed, impl):
    case = detections(seed)
    assert_same(run_port(*case, **KW), run_jax(*case, impl, **KW),
                f"seed {seed} vs {impl}")


@pytest.mark.parametrize("impl", ["lax", "pallas"])
def test_ties_below_threshold_and_ragged_n(impl):
    case = special_cases()
    got = run_port(*case, **KW)
    assert_same(got, run_jax(*case, impl, **KW), f"special vs {impl}")
    assert got[3][1] == 0  # the all-below-threshold image keeps nothing


@pytest.mark.parametrize("seed,n,d", [(3, 256, 25), (4, 77, 10),
                                      (5, 130, 128)])
def test_selection_matches_pallas_interpret(seed, n, d):
    boxes, scores, _ = detections(seed, n=n)
    for thr in (0.3, 0.5):
        want_s, want_i = pallas_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    d, 0.5, thr, interpret=True)
        got_s, got_i = greedy_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), d, 0.5, thr)
        assert got_i.dtype == torch.int32 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_tie_rule_picks_first_index():
    boxes, scores, _ = special_cases()
    s, i = nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                     3, 0.5, 0.3)
    # index 20 duplicates box 5 and is suppressed by it; 61 comes next
    assert i[0, :2].tolist() == [5, 61]
    assert s[0, :2].tolist() == [2.0, 2.0]


def test_yolo_scale_against_lax():
    # one image at YOLO-416 scale: N = 10,647 candidates, D = 100
    boxes, scores, classes = detections(11, b=1, n=10_647, n_classes=80)
    kw = dict(max_detections=100, iou_threshold=0.5, score_threshold=0.5)
    case = (boxes, scores, classes)
    assert_same(run_port(*case, **kw), run_jax(*case, "lax", **kw),
                "N=10647 vs lax")


def test_empty_candidate_set():
    s, i = greedy_nms(torch.zeros(2, 0, 4), torch.zeros(2, 0), 5, 0.5, 0.1)
    assert s.shape == (2, 5) and (i == -1).all() and (s == 0).all()


def test_wrapper_routes_by_device_and_counts_only_kernel_launches():
    boxes, scores, _ = detections(0)
    before = greedy_nms.launches
    greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 5, 0.5, 0.3)
    assert greedy_nms.launches == before  # the CPU ran the plain version
    with pytest.raises(ValueError, match="cpu or cuda"):
        greedy_nms(torch.zeros(1, 4, 4, device="meta"),
                   torch.zeros(1, 4, device="meta"), 5, 0.5, 0.3)


@pytest.mark.parametrize("boxes_shape,scores_shape,dtype", [
    ((2, 8, 3), (2, 8), torch.float32),
    ((2, 8, 4), (2, 7), torch.float32),
    ((2, 8, 4), (2, 8), torch.float64),
])
def test_wrapper_rejects_bad_inputs(boxes_shape, scores_shape, dtype):
    with pytest.raises((ValueError, TypeError)):
        greedy_nms(torch.zeros(boxes_shape, dtype=dtype),
                   torch.zeros(scores_shape, dtype=dtype), 5, 0.5, 0.3)

