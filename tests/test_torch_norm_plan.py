"""The BatchNorm moments kernel's grid and summation order, on the CPU.

`moments_plan` fixes the grid of csrc/norm.cu's bn_moments_fwd for a
(rows, C) matrix, and `moments_order_model` evaluates that kernel's sums
in its order with numpy in float32 (the kernel is built with
--fmad=false, so each product and each add rounds as numpy's do). Here:

- the plan covers every row and channel once, at every shape of the
  ResNet-50 training step (its 53 BatchNorms at batch 128, read off the
  port's model) and at edge shapes;
- the vectorised model equals a loop that walks the kernel's threads,
  lanes and combine groups one by one, bit for bit;
- at the step's two extremes, 1,605,632 rows x 1 channel (the stem's row
  count) and 6,272 x 2,048 (the last stage), the model's sums lie within
  1e-5 x sum |x| (sum x) and 1e-5 x sum x^2 (sum x^2) of a float64 sum,
  the tolerance chip_smoke.py holds the kernel to against the plain
  version. The card compares the kernel with this model bit for bit
  (tests/test_torch_cuda_kernels.py), so this is the kernel's error.
"""
import numpy as np
import pytest
import torch

from deep_vision_tpu_torch.nn.layers import BatchNorm
from deep_vision_tpu_torch.ops.cuda import norm

SMS = 132  # the H100's SMs
STEP_BATCH = 128
SUM_TOL = 1e-5


def resnet50_moment_shapes():
    """(rows, C) of each training BatchNorm of the ResNet-50 s2d step at
    batch 128: the port's model at batch 1 (eval, no gradients), rows
    scaled by the batch."""
    from deep_vision_tpu_torch.models import get_model

    model = get_model("resnet50", device="cpu", stem="s2d", seed=0,
                      num_classes=10)
    shapes = []

    def hook(mod, args):
        n, c, h, w = args[0].shape
        shapes.append((STEP_BATCH * n * h * w, c))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, 112, 112, 12))
    finally:
        for h in handles:
            h.remove()
    return shapes


@pytest.fixture(scope="module")
def step_shapes():
    return resnet50_moment_shapes()


def test_the_step_has_53_moment_shapes_from_the_stem_to_the_last_stage(
        step_shapes):
    assert len(step_shapes) == 53
    assert step_shapes[0] == (1_605_632, 64)
    assert max(step_shapes) == (1_605_632, 64)
    assert (6_272, 2048) in step_shapes
    elements = sum(r * c for r, c in step_shapes)
    assert 1.38e9 < elements < 1.46e9  # about 1.42 G a step


def check_plan(rows, c, elem_bytes, sms=SMS):
    plan = norm.moments_plan(rows, c, sms, elem_bytes)
    vec = plan.vec
    assert c % vec == 0 and vec in (1, 16 // elem_bytes)
    assert vec == 16 // elem_bytes or c % (16 // elem_bytes)
    vectors = c // vec
    # columns: the chunks of `cols` vectors cover every vector once
    assert plan.cols * plan.lanes <= norm.THREADS
    assert plan.col_blocks == -(-vectors // plan.cols)
    assert (plan.col_blocks - 1) * plan.cols < vectors
    # rows: splits of rows_per_split cover every row once, none empty
    assert plan.splits * plan.rows_per_split >= rows
    assert (plan.splits - 1) * plan.rows_per_split < rows
    assert plan.splits * plan.col_blocks <= max(
        sms * norm.MOMENTS_BLOCKS_PER_SM + plan.col_blocks, plan.col_blocks)
    assert plan.splits <= 65535 and plan.col_blocks <= 65535
    return plan


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_moments_plan_covers_every_step_shape(step_shapes, elem_bytes):
    for rows, c in set(step_shapes):
        plan = check_plan(rows, c, elem_bytes)
        # enough blocks to fill the card, each thread with several rows
        assert plan.splits * plan.col_blocks >= SMS
        per_thread = plan.rows_per_split / plan.lanes
        assert per_thread >= norm.MOMENTS_MIN_ROWS_PER_THREAD - 1


@pytest.mark.parametrize("rows,c,elem_bytes", [
    (1, 64, 2), (1, 3, 4), (7, 100, 2), (5, 2048, 4), (100_000, 1, 2),
    (33, 4096, 2), (1_605_632, 1, 4), (6_272, 2048, 2), (2, 2, 2)])
def test_moments_plan_covers_edge_shapes(rows, c, elem_bytes):
    check_plan(rows, c, elem_bytes)


def test_moments_plan_at_the_steps_extremes():
    # C = 64: 8 bf16 vectors a row, 32 rows a block, ~4 blocks an SM
    assert norm.moments_plan(1_605_632, 64, SMS, 2) == norm.MomentsPlan(
        vec=8, cols=8, lanes=32, col_blocks=1, splits=528,
        rows_per_split=3041)
    # C = 2048: one row at a time across 256 vectors, 12 rows a thread
    assert norm.moments_plan(6_272, 2048, SMS, 2) == norm.MomentsPlan(
        vec=8, cols=256, lanes=1, col_blocks=1, splits=523,
        rows_per_split=12)


def loop_model(x, plan):
    """The kernel's order written out thread by thread (slow)."""
    rows, c = x.shape
    vec, cols, lanes = plan.vec, plan.cols, plan.lanes
    part = np.zeros((plan.splits, 2, c), np.float32)
    for split in range(plan.splits):
        start = split * plan.rows_per_split
        end = min(start + plan.rows_per_split, rows)
        for chunk in range(plan.col_blocks):
            for col in range(cols):
                v = chunk * cols + col
                if v >= c // vec:
                    continue
                sums = []
                for lane in range(lanes):
                    s = np.zeros(vec, np.float32)
                    q = np.zeros(vec, np.float32)
                    for r in range(start + lane, end, lanes):
                        t = x[r, v * vec:(v + 1) * vec]
                        s = s + t
                        q = q + t * t
                    sums.append((s, q))
                for stat in (0, 1):
                    tot = sums[0][stat].copy()
                    for lane in range(1, lanes):
                        tot = tot + sums[lane][stat]
                    part[split, stat, v * vec:(v + 1) * vec] = tot
    out = []
    for stat in (0, 1):
        groups = [np.zeros(c, np.float32)
                  for _ in range(norm.COMBINE_GROUPS)]
        for j in range(plan.splits):
            groups[j % norm.COMBINE_GROUPS] = (
                groups[j % norm.COMBINE_GROUPS] + part[j, stat])
        tot = groups[0]
        for g in groups[1:]:
            tot = tot + g
        out.append(tot)
    return out


@pytest.mark.parametrize("rows,c,elem_bytes,sms", [
    (777, 16, 2, 3), (301, 12, 2, 2), (50, 24, 4, 5), (1000, 1, 4, 1),
    (9, 520, 2, 4)])
def test_the_vectorised_model_is_the_loop(rows, c, elem_bytes, sms):
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, c) * 3 + 1).astype(np.float32)
    plan = norm.moments_plan(rows, c, sms, elem_bytes)
    got = norm.moments_order_model(x, plan)
    want = loop_model(x, plan)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("rows,c,mean,std", [
    (1_605_632, 1, 0.0, 1.0), (1_605_632, 1, 3.0, 0.5),
    (6_272, 2048, 0.0, 1.0), (6_272, 2048, 3.0, 0.5)])
def test_the_kernels_order_against_a_float64_sum(rows, c, mean, std):
    """bf16 activations (the step's dtype) with and without an offset;
    the errors are printed beside torch's plain mean's for the record."""
    rng = np.random.RandomState(c)
    x = bf16((rng.randn(rows, c) * std + mean).astype(np.float32))
    plan = norm.moments_plan(rows, c, SMS, 2)
    s, q = norm.moments_order_model(x, plan)
    x64 = x.astype(np.float64)
    want_s, want_q = x64.sum(0), (x64 * x64).sum(0)
    abs_sum, sq_sum = np.abs(x64).sum(0), (x64 * x64).sum(0)
    err_s = np.abs(s - want_s) / abs_sum
    err_q = np.abs(q - want_q) / sq_sum
    xt = torch.from_numpy(x)
    plain_s = (xt.mean(0).double().numpy() * rows - want_s) / abs_sum
    plain_q = ((xt * xt).mean(0).double().numpy() * rows - want_q) / sq_sum
    print(f"rows {rows} C {c} mean {mean} std {std}: kernel order "
          f"{err_s.max():.3e} of sum|x|, {err_q.max():.3e} of sum x^2; "
          f"torch mean {np.abs(plain_s).max():.3e}, "
          f"{np.abs(plain_q).max():.3e}")
    assert err_s.max() <= SUM_TOL and err_q.max() <= SUM_TOL
