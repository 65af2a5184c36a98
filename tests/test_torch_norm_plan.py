"""The BatchNorm moments kernels' grids and arithmetic, on the CPU.

`moments_plan` fixes the grid of csrc/norm.cu's bn_moments_fwd for a
(rows, C) matrix: column chunks, CTAs in thread-block clusters, and
either one cluster a chunk (one launch) or several, whose partial rows
a combine launch adds. `moments_order_model` evaluates that kernel's sums in its order
with PyTorch's float32 elementwise ops (the kernel is built with
--fmad=false, so each product and each add rounds as those do).
`moments_bwd_plan` fixes the backward's grid. Here:

- the plans cover every row and channel once, at every shape of the
  ResNet-50 training step (its 53 BatchNorms at batch 128) and of the
  YOLOv3 step (its 72 at batch 16, 13 distinct), both read off the
  port's models, and at edge shapes; clusters have at most 16 CTAs;
- one cluster covers each chunk's rows, so the forward is one launch
  with no partial rows, at YOLOv3's 13x13, 26x26 and 52x52 shapes and
  ResNet's 7x7 and 14x14;
- the model equals a loop that walks the kernel's threads, lanes,
  cluster ranks and combine groups one by one, bit for bit, with one
  cluster a chunk and with several;
- at the steps' extremes the model's sums lie within 1e-5 x sum |x|
  (sum x) and 1e-5 x sum x^2 (sum x^2) of a float64 sum, the tolerance
  chip_smoke.py holds the kernel to against the plain version. The card
  compares the kernel with this model bit for bit
  (tests/test_torch_cuda_kernels.py), so this is the kernel's error;
- the backward kernel's coefficients, alpha = dE1 / N and beta = (2 dE2)
  / N in float32 with N rounded to float32, written as numpy, equal
  `bn_moments_bwd_coefficients` bit for bit.
"""
import numpy as np
import pytest
import torch

from deep_vision_tpu_torch.nn.layers import BatchNorm
from deep_vision_tpu_torch.ops.cuda import norm

SMS = 132  # the H100's SMs
STEP_BATCH = 128
YOLO_BATCH, YOLO_IMAGE = 16, 416
SUM_TOL = 1e-5


def moment_shapes(model, image, rows_per_pixel):
    """(rows, C) of each BatchNorm input of one forward of `model` on
    zeros of `image`'s shape (eval, no gradients), each (N, C, H, W)
    input counted as rows_per_pixel x N x H x W rows."""
    shapes = []

    def hook(mod, args):
        n, c, h, w = args[0].shape
        shapes.append((rows_per_pixel * n * h * w, c))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(image))
    finally:
        for h in handles:
            h.remove()
    return shapes


def resnet50_moment_shapes():
    """(rows, C) of each training BatchNorm of the ResNet-50 s2d step at
    batch 128: the port's model at batch 1, rows scaled by the batch."""
    from deep_vision_tpu_torch.models import get_model

    model = get_model("resnet50", device="cpu", stem="s2d", seed=0,
                      num_classes=10)
    return moment_shapes(model, (1, 112, 112, 12), STEP_BATCH)


def yolov3_moment_shapes():
    """(rows, C) of each training BatchNorm of the YOLOv3 step at batch 16
    and 416x416: the port's model on one 32x32 image, whose feature maps
    are 13 times smaller on a side (every stride divides 32), rows scaled
    by 16 x 13^2."""
    from deep_vision_tpu_torch.models import get_model

    model = get_model("yolov3", num_classes=80, device="cpu", seed=0,
                      train=True)
    side = YOLO_IMAGE // 32
    return moment_shapes(model, (1, 32, 32, 3), YOLO_BATCH * side * side)


@pytest.fixture(scope="module")
def step_shapes():
    return resnet50_moment_shapes()


@pytest.fixture(scope="module")
def yolo_shapes():
    return yolov3_moment_shapes()


def test_the_step_has_53_moment_shapes_from_the_stem_to_the_last_stage(
        step_shapes):
    assert len(step_shapes) == 53
    assert step_shapes[0] == (1_605_632, 64)
    assert max(step_shapes) == (1_605_632, 64)
    assert (6_272, 2048) in step_shapes
    elements = sum(r * c for r, c in step_shapes)
    assert 1.38e9 < elements < 1.46e9  # about 1.42 G a step


def test_the_yolov3_step_has_72_moment_shapes_13_distinct(yolo_shapes):
    assert len(yolo_shapes) == 72
    assert len(set(yolo_shapes)) == 13
    assert yolo_shapes[0] == (2_768_896, 32)  # 16 x 416 x 416
    assert min(yolo_shapes) == (2_704, 256)  # 16 x 13 x 13
    assert (2_704, 1024) in yolo_shapes
    # 612.6 M elements, 2.45 GB of float32 read by the forward
    assert sum(r * c for r, c in yolo_shapes) == 612_618_240


def thread_rows(plan, rows, cta, lane):
    """The rows the forward's thread of `lane` in CTA `cta` sums, in its
    order."""
    stride = plan.cluster * plan.clusters * plan.lanes
    return range(cta * plan.lanes + lane, rows, stride)


def check_plan(rows, c, elem_bytes, sms=SMS):
    plan = norm.moments_plan(rows, c, sms, elem_bytes)
    vec = plan.vec
    assert c % vec == 0 and vec in (1, 16 // elem_bytes)
    assert vec == 16 // elem_bytes or c % (16 // elem_bytes)
    vectors = c // vec
    # columns: the chunks of `cols` vectors cover every vector once
    assert plan.cols * plan.lanes <= norm.THREADS
    assert plan.lanes == norm.THREADS // plan.cols
    assert plan.chunks == -(-vectors // plan.cols)
    assert (plan.chunks - 1) * plan.cols < vectors
    assert plan.chunks <= 65535
    # clusters: at most 16 CTAs (above 8 the kernel sets the non-portable
    # attribute); the grid's x is cluster x clusters, a multiple of it
    assert 1 <= plan.cluster <= norm.MOMENTS_MAX_CLUSTER == 16
    assert plan.clusters == 1 or plan.cluster == norm.MOMENTS_TALL_CLUSTER
    assert plan.clusters >= 1
    assert plan.launches == (1 if plan.clusters == 1 else 2)
    # rows: the threads of a column cover every row once
    if rows <= 100_000:
        seen = sorted(r for cta in range(plan.cluster * plan.clusters)
                      for lane in range(plan.lanes)
                      for r in thread_rows(plan, rows, cta, lane))
        assert seen == list(range(rows))
    # with several clusters, at most one wave of MOMENTS_CTAS_PER_SM
    if plan.clusters > 1:
        assert (plan.cluster * plan.clusters * plan.chunks
                <= sms * norm.MOMENTS_CTAS_PER_SM)
    return plan


def check_step_plans(shapes, elem_bytes):
    for rows, c in set(shapes):
        plan = check_plan(rows, c, elem_bytes)
        per_thread = rows / (plan.cluster * plan.clusters * plan.lanes)
        ctas = plan.cluster * plan.clusters * plan.chunks
        # the card is full, 16 CTAs short of one an SM at most, unless the
        # chunks are as narrow as they go (64 bytes of a row)
        narrowest = plan.cols * plan.vec * elem_bytes == (
            norm.MOMENTS_MIN_CHUNK_BYTES)
        assert ctas >= SMS - norm.MOMENTS_MAX_CLUSTER or (
            narrowest and plan.clusters == 1), (rows, c, plan)
        if plan.clusters == 1:
            assert per_thread <= norm.MOMENTS_SINGLE_MAX_ROWS_PER_THREAD
        else:
            assert per_thread >= norm.MOMENTS_MIN_ROWS_PER_THREAD


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_moments_plan_covers_every_step_shape(step_shapes, elem_bytes):
    check_step_plans(step_shapes, elem_bytes)


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_moments_plan_covers_every_yolov3_step_shape(yolo_shapes,
                                                     elem_bytes):
    check_step_plans(yolo_shapes, elem_bytes)


@pytest.mark.parametrize("rows,c,elem_bytes", [
    (1, 64, 2), (1, 3, 4), (7, 100, 2), (5, 2048, 4), (100_000, 1, 2),
    (33, 4096, 2), (1_605_632, 1, 4), (6_272, 2048, 2), (2, 2, 2)])
def test_moments_plan_covers_edge_shapes(rows, c, elem_bytes):
    check_plan(rows, c, elem_bytes)


def test_moments_plan_at_the_steps_extremes():
    # C = 64 bf16, 1.6 M rows: whole 128-byte rows, 32 at a time a CTA;
    # 66 clusters of 4 CTAs (two an SM), each thread 190 rows, 66 partial
    # rows and a combine
    assert norm.moments_plan(1_605_632, 64, SMS, 2) == norm.MomentsPlan(
        vec=8, cols=8, lanes=32, chunks=1, cluster=4, clusters=66)
    # C = 2048 bf16, 6,272 rows: 16 chunks of 128 channels, a cluster of
    # 16 CTAs each, 392 rows a CTA; one launch
    assert norm.moments_plan(6_272, 2048, SMS, 2) == norm.MomentsPlan(
        vec=8, cols=16, lanes=16, chunks=16, cluster=16, clusters=1)
    # YOLOv3's 2,704 x 1,024 float32: 16 chunks of 64 channels, 256 CTAs
    assert norm.moments_plan(2_704, 1024, SMS, 4) == norm.MomentsPlan(
        vec=4, cols=16, lanes=16, chunks=16, cluster=16, clusters=1)


@pytest.mark.parametrize("model", ["yolov3", "resnet50"])
def test_one_cluster_covers_a_chunk_at_the_small_shapes(step_shapes,
                                                       yolo_shapes, model):
    """One launch, no partial rows, at YOLOv3's 13x13, 26x26 and 52x52
    shapes (float32) and ResNet-50's 7x7 and 14x14 (bf16)."""
    if model == "yolov3":
        sides, shapes, elem_bytes, batch = (13, 26, 52), yolo_shapes, 4, 16
    else:
        sides, shapes, elem_bytes, batch = (7, 14), step_shapes, 2, 128
    small = {(rows, c) for rows, c in shapes
             if rows in {batch * s * s for s in sides}}
    assert len(small) >= 4
    for rows, c in small:
        plan = norm.moments_plan(rows, c, SMS, elem_bytes)
        assert plan.clusters == 1 and plan.launches == 1, (rows, c, plan)


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_moments_bwd_plan_covers_every_row_and_vector_once(
        step_shapes, yolo_shapes, elem_bytes):
    shapes = set(step_shapes) | set(yolo_shapes) | {
        (1, 64), (1, 3), (7, 100), (33, 4096), (100_000, 1)}
    for rows, c in shapes:
        plan = norm.moments_bwd_plan(rows, c, SMS, elem_bytes)
        vectors = c // plan.vec
        assert plan.vec == norm.vector_width(c, elem_bytes)
        assert plan.lanes == norm.THREADS // plan.cols
        assert plan.chunks == -(-vectors // plan.cols)
        assert (plan.chunks - 1) * plan.cols < vectors
        # rows: thread (block, lane) walks rows block * lanes + lane with
        # a stride of blocks * lanes, so every row once when the blocks'
        # first rows reach all of them
        assert 1 <= plan.blocks and (plan.blocks - 1) * plan.lanes < rows
        # no more blocks than give a thread MOMENTS_BWD_MIN_ROWS_PER_THREAD
        # rows, nor than MOMENTS_BWD_CTAS_PER_SM CTAs an SM hold (the last
        # block's worth of rounding aside)
        assert ((plan.blocks - 1) * plan.lanes
                * norm.MOMENTS_BWD_MIN_ROWS_PER_THREAD < rows)
        assert (plan.blocks - 1) * plan.chunks < (
            SMS * norm.MOMENTS_BWD_CTAS_PER_SM)


def loop_model(x, plan):
    """The forward kernel's order written out thread by thread (slow)."""
    rows, c = x.shape
    vec, cols, lanes = plan.vec, plan.cols, plan.lanes
    k = plan.cluster
    part = np.zeros((plan.clusters, 2, c), np.float32)
    for chunk in range(plan.chunks):
        for col in range(cols):
            v = chunk * cols + col
            if v >= c // vec:
                continue
            ctas = []
            for cta in range(plan.cluster * plan.clusters):
                sums = []
                for lane in range(lanes):
                    s = np.zeros(vec, np.float32)
                    q = np.zeros(vec, np.float32)
                    for r in thread_rows(plan, rows, cta, lane):
                        t = x[r, v * vec:(v + 1) * vec]
                        s = s + t
                        q = q + t * t
                    sums.append((s, q))
                cta = []
                for stat in (0, 1):
                    tot = sums[0][stat].copy()
                    for lane in range(1, lanes):
                        tot = tot + sums[lane][stat]
                    cta.append(tot)
                ctas.append(cta)
            for g in range(plan.clusters):
                for stat in (0, 1):
                    tot = ctas[g * k][stat].copy()
                    for rank in range(1, k):
                        tot = tot + ctas[g * k + rank][stat]
                    part[g, stat, v * vec:(v + 1) * vec] = tot
    out = []
    for stat in (0, 1):
        if plan.clusters == 1:
            tot = part[0, stat]
        else:
            groups = [np.zeros(c, np.float32)
                      for _ in range(norm.COMBINE_GROUPS)]
            for j in range(plan.clusters):
                groups[j % norm.COMBINE_GROUPS] = (
                    groups[j % norm.COMBINE_GROUPS] + part[j, stat])
            tot = groups[0]
            for g in groups[1:]:
                tot = tot + g
        out.append(tot / np.float32(rows))
    return out


@pytest.mark.parametrize("rows,c,elem_bytes,sms", [
    (777, 16, 2, 3), (301, 12, 2, 2), (50, 24, 4, 5), (1000, 1, 4, 1),
    (9, 520, 2, 4)])
def test_the_vectorised_model_is_the_loop(rows, c, elem_bytes, sms):
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, c) * 3 + 1).astype(np.float32)
    plan = norm.moments_plan(rows, c, sms, elem_bytes)
    got = norm.moments_order_model(torch.from_numpy(x), plan)
    want = loop_model(x, plan)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("rows,c,plan", [
    (777, 16, norm.MomentsPlan(vec=4, cols=2, lanes=128, chunks=2,
                               cluster=3, clusters=5)),
    (1000, 1, norm.MomentsPlan(vec=1, cols=1, lanes=256, chunks=1,
                               cluster=2, clusters=11)),
    (301, 12, norm.MomentsPlan(vec=4, cols=3, lanes=85, chunks=1,
                               cluster=16, clusters=2))])
def test_the_model_is_the_loop_with_several_clusters(rows, c, plan):
    """Grids with a combine: more clusters than COMBINE_GROUPS, and rows
    that end part-way through a stride."""
    rng = np.random.RandomState(c)
    x = (rng.randn(rows, c) * 3 + 1).astype(np.float32)
    got = norm.moments_order_model(torch.from_numpy(x), plan)
    want = loop_model(x, plan)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("rows,c,mean,std", [
    (1_605_632, 1, 0.0, 1.0), (1_605_632, 1, 3.0, 0.5),
    (6_272, 2048, 0.0, 1.0), (6_272, 2048, 3.0, 0.5),
    (2_704, 1024, 0.0, 1.0), (43_264, 256, 3.0, 0.5)])
def test_the_kernels_order_against_a_float64_sum(rows, c, mean, std):
    """bf16 activations (the ResNet step's dtype) with and without an
    offset; the errors are printed beside torch's plain mean's for the
    record."""
    rng = np.random.RandomState(c)
    x = bf16((rng.randn(rows, c) * std + mean).astype(np.float32))
    plan = norm.moments_plan(rows, c, SMS, 2)
    e1, e2 = (t.double().numpy() * rows
              for t in norm.moments_order_model(torch.from_numpy(x), plan))
    x64 = x.astype(np.float64)
    want_s, want_q = x64.sum(0), (x64 * x64).sum(0)
    abs_sum, sq_sum = np.abs(x64).sum(0), (x64 * x64).sum(0)
    err_s = np.abs(e1 - want_s) / abs_sum
    err_q = np.abs(e2 - want_q) / sq_sum
    xt = torch.from_numpy(x)
    plain_s = (xt.mean(0).double().numpy() * rows - want_s) / abs_sum
    plain_q = ((xt * xt).mean(0).double().numpy() * rows - want_q) / sq_sum
    print(f"rows {rows} C {c} mean {mean} std {std}: kernel order "
          f"{err_s.max():.3e} of sum|x|, {err_q.max():.3e} of sum x^2; "
          f"torch mean {np.abs(plain_s).max():.3e}, "
          f"{np.abs(plain_q).max():.3e}")
    assert err_s.max() <= SUM_TOL and err_q.max() <= SUM_TOL


@pytest.mark.parametrize("n", [
    1, 3, 169, 2_704, 10_816, 43_264, 2_768_896, 2**24 + 1, 3 * 2**23 + 1,
    3 * 2**23 + 3, 2**31 + 5])
def test_the_backward_kernels_coefficients_are_the_plain_ones(n):
    """csrc/norm.cu's bn_moments_bwd forms alpha = dE1 / N and beta =
    (2 dE2) / N in float32 (__fdiv_rn, N by static_cast<float>, round to
    nearest even: above 2^24 N is rounded), here in numpy; the plain
    version's coefficients must be these bits, odd N and N above 2^24
    included, for every magnitude (denormals, zeros of both signs, 2 dE2
    overflowing to inf)."""
    rng = np.random.RandomState(n % 2**31)
    scale = 10.0 ** rng.randint(-44, 38, 4096)
    d1 = (rng.randn(4096) * scale).astype(np.float32)
    d2 = (rng.randn(4096) * scale).astype(np.float32)
    d1[:4] = d2[:4] = [0.0, -0.0, 3.0e38, -3.0e38]
    nf = np.float32(n)
    assert int(nf) == n or n > 2**24
    with np.errstate(over="ignore"):
        alpha, beta = d1 / nf, (np.float32(2.0) * d2) / nf
    a, b = norm.bn_moments_bwd_coefficients(n, torch.from_numpy(d1),
                                            torch.from_numpy(d2))
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                  alpha.view(np.uint32))
    np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                  beta.view(np.uint32))


def c_signatures(source):
    """{name: [ctypes type of each parameter]} of the extern "C" functions
    in a CUDA source, read from its text."""
    import ctypes
    import re

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    sigs = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   source):
        types = []
        for p in filter(None, (p.strip() for p in params.split(","))):
            words = p.replace("const ", "").rsplit(None, 1)[0]
            types.append(ctypes.c_void_p if "*" in p else kinds[words])
        sigs[name] = types
    return sigs


def test_the_ctypes_signatures_match_norm_cu():
    """A 32-bit argtype for a 64-bit parameter leaves the upper half of
    the argument undefined, so each wrapper's argtypes must be the C
    function's parameter types, one for one."""
    from deep_vision_tpu_torch.ops.cuda import build

    sigs = c_signatures((build.CSRC_DIR / "norm.cu").read_text())
    assert set(sigs) == set(norm._ARGTYPES)
    for name, types in sigs.items():
        assert norm._ARGTYPES[name] == types, name
