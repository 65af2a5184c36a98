"""Port parity: deep_vision_tpu_torch/ops/boxes.py and the YOLO decode of
inference.py against the JAX package, on numpy inputs from a seed.

Tolerance rtol = atol = 1e-6 where sigmoid/exp enter: XLA and PyTorch
evaluate those transcendentals with different polynomial kernels, which
agree to about 1 ulp in float32 (~1.2e-7 relative); arithmetic-only
transforms (xywh_to_xyxy, the grid) must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.inference import yolo_decode_outputs as jax_decode_outputs
from deep_vision_tpu.ops import boxes as jax_boxes
from deep_vision_tpu_torch.inference import yolo_decode_outputs
from deep_vision_tpu_torch.ops import anchors as port_anchors
from deep_vision_tpu_torch.ops import boxes as port_boxes

TOL = dict(rtol=1e-6, atol=1e-6)


def rand_boxes(rng, *shape):
    xy = rng.rand(*shape, 2).astype(np.float32) * 0.8
    wh = rng.rand(*shape, 2).astype(np.float32) * 0.3
    return np.concatenate([xy, xy + wh], -1)


def test_xywh_to_xyxy_exact():
    x = np.random.RandomState(0).rand(3, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(
        port_boxes.xywh_to_xyxy(torch.from_numpy(x)).numpy(),
        np.asarray(jax_boxes.xywh_to_xyxy(jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 1])
def test_broadcast_iou(seed):
    rng = np.random.RandomState(seed)
    a, b = rand_boxes(rng, 2, 7), rand_boxes(rng, 2, 11)
    a[0, 0] = [0.5, 0.5, 0.4, 0.4]  # inverted box: sides clip to 0
    want = np.asarray(jax_boxes.broadcast_iou(jnp.asarray(a), jnp.asarray(b)))
    got = port_boxes.broadcast_iou(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, 7, 11)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_grid_offsets_exact():
    np.testing.assert_array_equal(
        port_boxes._grid_offsets(3, 5).numpy(),
        np.asarray(jax_boxes._grid_offsets(3, 5)))


@pytest.mark.parametrize("grid", [(4, 4), (3, 5)])
def test_decode_yolo_boxes(grid):
    rng = np.random.RandomState(sum(grid))
    pred = (rng.randn(2, *grid, 3, 9) * 3).astype(np.float32)
    pred[0, 0, 0, 0, 2:4] = [20.0, -20.0]  # exercises the exp clip
    anchors = port_anchors.YOLO_ANCHORS[[6, 7, 8]]
    want = jax_boxes.decode_yolo_boxes(jnp.asarray(pred), jnp.asarray(anchors))
    got = port_boxes.decode_yolo_boxes(torch.from_numpy(pred),
                                       torch.from_numpy(anchors))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_anchor_constants_match():
    from deep_vision_tpu.ops import anchors as jax_anchors

    np.testing.assert_array_equal(port_anchors.YOLO_ANCHORS,
                                  jax_anchors.YOLO_ANCHORS)
    np.testing.assert_array_equal(port_anchors.YOLO_ANCHOR_MASKS,
                                  jax_anchors.YOLO_ANCHOR_MASKS)


def test_yolo_decode_outputs():
    rng = np.random.RandomState(9)
    outs = [(rng.randn(2, g, g, 3, 4 + 5) * 2).astype(np.float32)
            for g in (2, 4, 8)]
    wb, ws = jax_decode_outputs([jnp.asarray(o) for o in outs])
    gb, gs = yolo_decode_outputs([torch.from_numpy(o) for o in outs])
    assert gb.shape == (2, 252, 4) and gs.shape == (2, 252, 4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
