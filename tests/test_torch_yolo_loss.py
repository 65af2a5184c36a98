"""Port parity: YOLO anchor assignment (deep_vision_tpu_torch/ops/
anchors.py), the box encode (ops/boxes.py) and the YOLOv3 loss
(losses/yolo.py) against the JAX package on the CPU, on small grids with
few classes.

Inputs are drawn with numpy from a seed. Tolerances, with their reasons:
- the assignment and the encode's tx, ty: bitwise. The same float32
  elementwise formulas on the same inputs, and the writer of a (cell,
  slot) that several boxes hit is the last box, as the reference's
  `.at[].set` leaves it on the CPU. The encode's tw, th within two ulps
  (rtol and atol 2.5e-7): XLA's and PyTorch's float32 `log` differ by
  an ulp on a few inputs.
- the loss terms and their gradients with respect to the head outputs:
  rtol 1e-5, atol 1e-5 x the largest magnitude. Both sides sum the same
  float32 terms in other orders (XLA's reductions against PyTorch's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.losses.yolo import yolo_train_loss_fn as jax_loss
from deep_vision_tpu.ops.anchors import (
    assign_anchors_to_grid as jax_assign,
)
from deep_vision_tpu.ops.boxes import encode_yolo_boxes as jax_encode
from deep_vision_tpu.ops.boxes import xyxy_to_xywh as jax_xyxy_to_xywh
from deep_vision_tpu_torch.losses.yolo import (
    yolo_loss_per_scale,
    yolo_train_loss_fn,
)
from deep_vision_tpu_torch.ops.anchors import (
    YOLO_ANCHOR_MASKS,
    YOLO_ANCHORS,
    assign_anchors_to_grid,
)
from deep_vision_tpu_torch.ops.boxes import encode_yolo_boxes, xyxy_to_xywh

GRIDS = (2, 4, 8)  # a 64 x 64 input
NUM_CLASSES = 3
RTOL = 1e-5


def seeded_boxes(seed, b=3, n=12, padded=4):
    """(B, N, 4) xyxy boxes in [0, 1] with `padded` zero rows an image,
    and (B, N) classes, some outside [0, NUM_CLASSES)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.0, 0.8, (b, n, 2))
    wh = rng.uniform(0.01, 0.6, (b, n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1)
    boxes[:, n - padded:] = 0.0
    classes = rng.randint(-1, NUM_CLASSES + 1, (b, n))
    return boxes.astype(np.float32), classes.astype(np.int32)


def colliding_boxes():
    """Boxes that share a cell and an anchor at every scale: three copies
    of one box with other classes, two near-copies, and a padded row in
    between."""
    base = np.array([0.30, 0.30, 0.45, 0.50], np.float32)
    boxes = np.stack([base, base, np.zeros(4, np.float32), base,
                      base + 0.001, base - 0.001,
                      np.array([0.1, 0.1, 0.9, 0.95], np.float32),
                      np.array([0.1, 0.1, 0.92, 0.96], np.float32)])
    classes = np.array([0, 1, 2, 2, 1, 0, 1, 2], np.int32)
    return boxes[None], classes[None]


def jax_targets(boxes, classes):
    xywh = jax_xyxy_to_xywh(jnp.asarray(boxes))
    out = jax.vmap(lambda b, c: tuple(jax_assign(
        b, c, GRIDS, YOLO_ANCHORS, YOLO_ANCHOR_MASKS, NUM_CLASSES)))(
        xywh, jnp.asarray(classes))
    return [np.asarray(t) for t in out]


def port_targets(boxes, classes):
    xywh = xyxy_to_xywh(torch.from_numpy(boxes))
    return [t.numpy() for t in assign_anchors_to_grid(
        xywh, torch.from_numpy(classes), GRIDS, num_classes=NUM_CLASSES)]


@pytest.mark.parametrize("case", ["seeded", "colliding"])
def test_assignment_equals_the_reference_bitwise(case):
    boxes, classes = (seeded_boxes(0) if case == "seeded"
                      else colliding_boxes())
    want = jax_targets(boxes, classes)
    got = port_targets(boxes, classes)
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (len(boxes), g, g, 3, 5 + NUM_CLASSES) for g in GRIDS]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(float(t[..., 4].sum()) for t in got) > 0


def test_the_last_of_colliding_boxes_is_written():
    boxes, classes = colliding_boxes()
    got = port_targets(boxes, classes)
    xywh = xyxy_to_xywh(torch.from_numpy(boxes))[0].numpy()
    filled = [(s, tuple(i)) for s, t in enumerate(got)
              for i in np.argwhere(t[0, ..., 4] > 0)]
    # boxes 0, 1, 3 are one box; 4 and 5 shift it by 0.001: the same cell
    # and anchor, so box 5 (the last) wins; 6 and 7 likewise, 7 wins
    assert len(filled) == 2
    rows = [got[s][0][i] for s, i in filled]
    written = sorted(tuple(r[:4]) for r in rows)
    assert written == sorted([tuple(xywh[5]), tuple(xywh[7])])
    by_box = {tuple(r[:4]): r for r in rows}
    np.testing.assert_array_equal(by_box[tuple(xywh[5])][5:], [1, 0, 0])
    np.testing.assert_array_equal(by_box[tuple(xywh[7])][5:], [0, 0, 1])


def test_encode_equals_the_reference_bitwise():
    boxes, _ = seeded_boxes(1)
    xywh = jax_xyxy_to_xywh(jnp.asarray(boxes))
    np.testing.assert_array_equal(xyxy_to_xywh(torch.from_numpy(boxes)),
                                  np.asarray(xywh))
    per_anchor = np.repeat(np.asarray(xywh)[..., None, :], 3, axis=-2)
    anchors = YOLO_ANCHORS[YOLO_ANCHOR_MASKS[1]]
    want = np.asarray(jax_encode(jnp.asarray(per_anchor), anchors, 4))
    got = encode_yolo_boxes(torch.from_numpy(per_anchor),
                            torch.from_numpy(anchors), 4).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=2.5e-7,
                               atol=2.5e-7)


def close(got, want, name):
    want = np.asarray(want, np.float32)
    atol = RTOL * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_loss_every_key_and_gradient_match_the_reference(seed):
    boxes, classes = seeded_boxes(seed + 2)
    rng = np.random.RandomState(seed)
    outputs = [(rng.randn(len(boxes), g, g, 3, 5 + NUM_CLASSES) * 2.0)
               .astype(np.float32) for g in GRIDS]
    # some predictions near the boxes, so the ignore mask is not empty
    outputs[2][..., 0:4] *= 0.1

    def f(outs):
        return jax_loss(outs, {"boxes": jnp.asarray(boxes),
                               "classes": jnp.asarray(classes)},
                        grid_sizes=GRIDS, num_classes=NUM_CLASSES)

    (want, want_m), want_g = jax.value_and_grad(f, has_aux=True)(
        tuple(jnp.asarray(o) for o in outputs))
    outs = [torch.from_numpy(o).requires_grad_() for o in outputs]
    got, got_m = yolo_train_loss_fn(
        outs, {"boxes": torch.from_numpy(boxes),
               "classes": torch.from_numpy(classes)},
        grid_sizes=GRIDS, num_classes=NUM_CLASSES)
    got.backward()
    assert sorted(got_m) == sorted(want_m) == sorted(
        ["loss", "loss_large", "loss_medium", "loss_small", "large_xy",
         "large_wh", "large_obj", "large_noobj", "large_class"])
    for k in want_m:
        close(got_m[k].detach(), want_m[k], k)
    close(got.detach(), want, "loss")
    for o, w, g in zip(outs, want_g, GRIDS):
        close(o.grad, w, f"d loss / d output (grid {g})")


def test_ignore_mask_leaves_out_overlapping_background():
    """A confident prediction that matches a ground-truth box in a cell
    the box does not own takes no no-object loss."""
    xywh = torch.tensor([[[0.5, 0.5, 0.5, 0.5]]])
    target = torch.zeros(1, 2, 2, 1, 5 + NUM_CLASSES)
    anchors = torch.tensor([[0.5, 0.5]])
    pred = torch.full((1, 2, 2, 1, 5 + NUM_CLASSES), -4.0)
    pred[..., 2:4] = float(np.log(0.4))  # boxes of side 0.2: IoU <= 0.16
    pred[..., 4] = 3.0
    pred[0, 0, 0, 0, 0:2] = 10.0  # centred near (0.5, 0.5)
    pred[0, 0, 0, 0, 2:4] = 0.0  # of the anchor's side: IoU ~1
    loss = yolo_loss_per_scale(pred, target, xywh, anchors)
    others = 3 * float(torch.nn.functional.softplus(torch.tensor(3.0)))
    assert abs(float(loss["noobj"]) - 0.5 * others) < 1e-5
