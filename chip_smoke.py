#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py          # from the repository root; one card

Phases (any failure exits non-zero; nothing is caught and logged away):

1. setup   the card's name and power limit, torch/CUDA versions, TF32 off
           (the JAX YOLOv3 is a float32 model);
2. build   every kernel under deep_vision_tpu_torch/csrc with nvcc, and
           ptxas's registers and spills for each (none allowed in any
           kernel of flash_attention.cu: the Hopper kernels
           flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90, and the
           float32 flash_fwd, flash_dq and flash_dkv; nor in norm.cu);
3. kernels each kernel against its plain PyTorch version on the card:
           NMS, exact equality, over the cases of kernel_cases() (serving
           sizes, the CPU model's edge cases, M > K) and the edge cases
           again at K = 64 (several passes); bn_act
           at every (shape, residual) the flagship training step gives
           it, in f32 and bf16, channels_last and NCHW, ReLU and none,
           plus an odd C: forward, dx and dres exactly equal, dscale and
           dbias within BN_SUM_TOL of the sum of |terms| per channel;
           kernel, plain and bound times, summed over one step's calls,
           and each wrapper's host cost per call; flash attention over
           flash_cases() (the ViT step's shape in bf16 and f32, causal,
           cross, ragged T, D 32 and 128, scores x120), forward with lse
           and the dq/dkv backward with and without an lse cotangent,
           within FLASH_TOL (also T 129 with Tk 65, one query against
           1024 keys, causal cross attention 256 x 1024; bf16 dq runs
           flash_dq_sm90); kernel, plain, bound and
           scaled_dot_product_attention times at the step's shape;
4. serve   YOLOv3 at 416x416, 80 classes, seeded weights, through the
           port's Engine (buckets 1, 2, 4, 8) and Server: a mixed burst
           stream, response checks, the NMS launch count against the
           batch count, one batch against the same predictor with the
           plain NMS, per-bucket latency, SLO quantiles, drain ledger;
           then NMS at the served batch's inputs: M per image, passes,
           one call under CUDA's sync debug mode (a host sync raises),
           kernel and plain times at B = 8 and the kernel's at B = 1;
5. train   the flagship step (ResNet-50, s2d stem, bf16, batch 128,
           SGD) through the port's Trainer: warm-up and timed steps,
           48 + 48 bn_act and 53 + 53 moments launches per step, a finite
           and falling loss;
           then one float32 step at batch 8 on the card (kernels)
           against the same step on the CPU (plain versions); then
           ViT-S/16 at 512x512 (bf16, batch 64, AdamW + warmup-cosine)
           through the Trainer: 12 + 12 + 12 flash and 25 + 25 LayerNorm
           launches a step, a finite and falling loss; a 224x224
           vit_s16 forward that
           launches no flash kernel (the dense route); and one float32
           batch-2 ViT step on the card against the CPU: loss, grad norm
           and every parameter's gradient within VIT_CHECK_TOL;
6. report  the card line, the kernels line, and the final status line.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
#: float32 (non-tensor-core) FLOP/s, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: float32 operations per candidate per NMS round: the IoU against the
#: pick (4 min/max + 2 sub + 2 clip for the sides, 1 mul, 2 sub + 2 clip
#: + 1 mul for the area, 1 add + 1 sub + 1 clip for the union, 1 div,
#: 1 compare) and 1 compare in the arg-max reduction
NMS_OPS_PER_CANDIDATE = 21
#: bn_act dscale/dbias: |kernel - plain| <= BN_SUM_TOL * sum |terms| per
#: channel (two float32 summation orders of up to 1e8 terms)
BN_SUM_TOL = 1e-5
#: float32 operations per element: forward x*a + b (+ r) and the ReLU;
#: backward the mask, g'*a, and the two running sums (mul + 2 adds)
BN_FWD_OPS, BN_BWD_OPS = 4, 5

#: norm kernels against plain versions: the moments' E[x] and E[x^2]
#: within NORM_SUM_TOL x the mean of |terms| per channel (two float32
#: summation orders over up to 1.6 M rows), LayerNorm's dscale and dbias
#: (sums over every row) within NORM_SUM_TOL x k x sum |terms|; LayerNorm's
#: y, mean, rstd and dx within rtol and atol u + LN_TOL x k (atol relative
#: to the tensor's largest magnitude), u one bf16 ulp for a bf16 result,
#: k the worst row's E[x^2] / (var + eps): the fast variance loses k ulps
#: to cancellation, so two summation orders differ by that much
NORM_SUM_TOL = 1e-5
LN_TOL = 2e-6
BF16_ULP = 2.0 ** -7
#: float32 operations per element: moments forward (x + s, x * x + q) and
#: backward (alpha + beta * x); LayerNorm forward (two sums and a square,
#: then (x - mean) * (rstd * scale) + bias) and backward (E[x^2] again, h,
#: x^, the two row sums, dx, the two column sums)
MOMENTS_FWD_OPS, MOMENTS_BWD_OPS, LN_FWD_OPS, LN_BWD_OPS = 3, 2, 7, 15
#: the one PyTorch call timed beside each moments kernel (never on the path)
LIBRARY_CALL = {"bn_moments_fwd": "torch.batch_norm_stats",
                "bn_moments_bwd": "torch.addcmul"}

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet) and the
#: special-function units' exponential rate: 16 a clock on each of 132
#: SMs (Hopper white paper) at the 1.98 GHz maximum boost clock
BF16_FLOPS = 989e12
EXP_PER_S = 132 * 16 * 1.98e9
#: flash kernel against plain version, (rtol, atol, atol relative to the
#: compared tensor's largest magnitude?), tests/test_pallas.py's: f32
#: out/lse (:29-30) and dq/dk/dv (:105-107); scores x120 (:50-57), where
#: near-one-hot rows turn a one-ulp score difference into a weight
#: difference; bf16 out (:82-85) and dq/dk/dv relative to the largest
#: |value| (the kernels round P and dS to bf16 for the second products)
FLASH_TOL = {
    ("f32", "out"): (2e-4, 2e-5, False), ("f32", "grad"): (2e-4, 2e-4, True),
    ("x120", "out"): (2e-3, 1e-4, False), ("x120", "grad"): (2e-3, 1e-3, True),
    ("bf16", "out"): (2e-2, 2e-2, False), ("bf16", "grad"): (0.0, 2e-2, True),
    ("lse", "out"): (2e-4, 2e-5, False),
}
VIT_BATCH, VIT_IMAGE = 64, 512
VIT_CHECK_BATCH = 2
#: the float32 ViT step, card (kernels) against CPU (plain versions): loss
#: and grad norm relative; each parameter's gradient relative to the
#: largest magnitude of its tensor. Both sides sum f32 products in other
#: orders (cuBLAS and the flash kernels' 64-key tiles against MKL and the
#: dense plain softmax).
VIT_CHECK_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "grad": 2e-3}

IMAGE = 416
NUM_CLASSES = 80
BUCKETS = (1, 2, 4, 8)
MAX_DET = 100
IOU_THR = 0.5
SCORE_THR = 0.5
BURSTS = (1, 3, 2, 8, 5, 4, 7, 6, 8, 1)
TIMED_RUNS = 25
#: ~30 ms of spinning at the H100's clocks: longer than the host takes to
#: queue TIMED_RUNS calls of any timed function
SPIN_CYCLES = 50_000_000
#: twice the H100's L2 cache
L2_FLUSH_BYTES = 100 * 2**20
TRAIN_BATCH = 128
WARMUP_STEPS, TIMED_STEPS = 3, 10
CHECK_BATCH = 8
#: the float32 batch-8 step, card (kernels) against CPU (plain versions):
#: loss and grad norm relative; each parameter's update and each running
#: statistic relative to the largest magnitude of its tensor. cuDNN and
#: the CPU's convolutions sum in other orders, and a ReLU input or a
#: max-pool pair within an ulp of a tie can fall the other way, sending
#: one element's gradient elsewhere (tests/test_torch_train.py)
CHECK_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "update": 2e-2, "stats": 1e-3}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_cuda(torch, fn, runs=TIMED_RUNS, warmup=3):
    """(device ms, host us): medians over `runs` calls of `fn()`.

    Device: each call between its own pair of CUDA events, each after a
    write of L2_FLUSH_BYTES, which leaves the 50 MB L2 cache holding none
    of fn's inputs (a conv's output reaches the next layer no warmer). A
    spin kernel queued first holds the stream while the host queues the
    calls, so the host's time per call (checks, allocation, launch) does
    not show in the device reading, as long as the host queues them all
    within the spin; where it cannot (the plain NMS, ~1,500 launches a
    call), the reading includes the device's waits on the host.
    Host: the host clock around each `fn()` call, the device held by the
    spin: what each call adds to a step's host time, which the step
    times of phase 5 include."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    host = []
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in pairs:
        flush.zero_()
        start.record()
        t = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t) * 1e6)
        end.record()
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in pairs),
            statistics.median(host))


def kernel_cases():
    """(label, boxes, scores, max_detections, iou_threshold,
    score_threshold) for phase 3: serving-sized images, then the edge
    cases the CPU model of the NMS kernels rehearses, then more
    candidates than one pass (K = 4096) takes."""
    from deep_vision_tpu_torch.tools.nms_cases import (
        detections,
        edge_cases,
        large_cases,
    )

    cases = []
    for b in (1, 8):
        for thr in (0.3, 0.5):
            boxes, scores = detections(b, b, 10_647)
            cases.append((f"B={b} N=10647 thr={thr}", boxes, scores, MAX_DET,
                          IOU_THR, thr))
    boxes, scores = detections(3, 1, 10_647)
    scores[0, [17, 4000, 9000]] = 2.0  # the tie rule: first index wins
    boxes[0, 4000] = boxes[0, 17]
    cases.append(("ties on the top score, N=10647", boxes, scores, MAX_DET,
                  IOU_THR, 0.5))
    boxes, scores = detections(4, 1, 10_647)
    cases.append(("all scores below threshold", boxes, scores * 0.2,
                  MAX_DET, IOU_THR, 0.5))
    return cases + edge_cases() + large_cases()


def check_nms(torch, dev):
    """Phase 3 for NMS: every case of kernel_cases() at the default K, and
    the edge cases again at K = 64, where most take several passes; the
    kernels' output must equal the plain version's exactly."""
    from deep_vision_tpu_torch.ops.cuda import nms
    from deep_vision_tpu_torch.tools.nms_cases import edge_cases

    runs = [(case, nms.PASS_CANDIDATES) for case in kernel_cases()]
    runs += [(case, 64) for case in edge_cases()]
    default_k = nms.PASS_CANDIDATES
    try:
        for (label, boxes, scores, d, iou, thr), k in runs:
            nms.PASS_CANDIDATES = k
            b = torch.from_numpy(boxes).to(dev)
            s = torch.from_numpy(scores).to(dev)
            got = nms.greedy_nms(b, s, d, iou, thr)
            torch.cuda.synchronize()
            want = nms.nms_plain(b, s, d, iou, thr)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            kept = (got[1] >= 0).sum(dim=1).tolist()
            ms, passes, _ = nms.selection_plan(s, want[1], thr, k)
            print(f"[kernels] nms {label} (B {b.shape[0]}, N {b.shape[1]}, "
                  f"D {d}, iou {iou}, score {thr}, K {k}): "
                  f"{'equal' if same else 'DIFFERENT'}; M {ms}, passes "
                  f"{passes}, picks {kept}")
            check(same, f"nms kernels differ from the plain version: {label}"
                  f" at K {k}")
            if label.startswith("ties on the top score, N"):
                check(got[1][0, :2].tolist() == [17, 9000],
                      f"tie rule: picks {got[1][0, :3].tolist()}")
            if label.startswith("all scores"):
                check(sum(kept) == 0, "an all-below-threshold image kept a "
                      "box")
    finally:
        nms.PASS_CANDIDATES = default_k
    print(f"[kernels] nms: {len(runs)} cases equal to the plain version")


def batchnorm_calls(torch, model, images):
    """({(NCHW shape, has residual): calls} of the bn_act calls and
    {NCHW shape: calls} of the batch moments one training forward of
    `model` makes (every BatchNorm takes its batch's moments), read by
    hooks on its BatchNorms in an eval pass without gradients: the
    training step's shapes, and no running statistic changes."""
    from deep_vision_tpu_torch.nn.layers import BatchNorm

    calls, moments = {}, {}

    def hook(mod, args, kwargs):
        res = kwargs.get("residual") is not None
        shape = tuple(args[0].shape)
        moments[shape] = moments.get(shape, 0) + 1
        if mod.act is not None or res:
            key = (shape, res)
            calls[key] = calls.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, BatchNorm)]
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(images)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return calls, moments


def bn_act_cases(torch, dev, calls, card):
    """Phase 3 for bn_act: every (shape, residual) of `calls` and two with
    an odd C, in f32 and bf16, channels_last and contiguous NCHW, ReLU
    and none. The forward, dx and dres must equal the plain version's;
    dscale and dbias must lie within BN_SUM_TOL * sum |terms| of it.
    The main path's configuration (bf16, channels_last, ReLU) is timed
    per shape. Returns the kernels line's fields for bn_act_fwd and
    bn_act_bwd, times summed over the calls of one step."""
    from deep_vision_tpu_torch.ops.cuda.bn_act import (
        bn_act_backward,
        bn_act_bwd_plain,
        bn_act_forward,
        bn_act_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = sorted((shape, res, n) for (shape, res), n in calls.items())
    cases += [((5, 100, 13, 11), True, 0), ((3, 100, 7, 9), False, 0)]
    # per-step sums by (kernel, residual): the TPU had `_kernel` and
    # `_kernel_res` (bn_act.py:78, :89), the port one forward kernel
    parts = {(name, res): dict(calls=0, ms=0.0, plain_ms=0.0, host_ms=0.0,
                               bytes=0, ops=0)
             for name in ("bn_act_fwd", "bn_act_bwd")
             for res in (False, True)}
    max_err = {"bn_act_fwd": 0.0, "bn_act_bwd": 0.0}
    n_checked = 0
    for shape, res, n in cases:
        c = shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            for fmt in (torch.channels_last, torch.contiguous_format):
                def draw():
                    return torch.randn(shape, generator=gen, device=dev).to(
                        dtype).contiguous(memory_format=fmt)

                x, g = draw(), draw()
                r = draw() if res else None
                a = torch.rand(c, generator=gen, device=dev) + 0.5
                b = torch.randn(c, generator=gen, device=dev)
                for act in ("relu", None):
                    layout = ("channels_last" if fmt is torch.channels_last
                              else "NCHW")
                    label = f"{shape} residual={res} {dtype} {layout} {act}"
                    y = bn_act_forward(x, a, b, r, act)
                    yp = bn_act_plain(x, a, b, r, act)
                    check(torch.equal(y, yp) and y.stride() == x.stride(),
                          f"bn_act forward differs: {label}")
                    max_err["bn_act_fwd"] = max(max_err["bn_act_fwd"], float(
                        (y.float() - yp.float()).abs().max()))
                    got = bn_act_backward(x, a, yp, g, act, res)
                    want = bn_act_bwd_plain(x, a, yp, g, act, res)
                    check(torch.equal(got[0], want[0]), f"bn_act dx: {label}")
                    check(not res or torch.equal(got[3], want[3]),
                          f"bn_act dres: {label}")
                    gf = g.float()
                    if act == "relu":
                        gf = torch.where(yp > 0, gf, 0.0)
                    terms = ((gf * x.float()).abs().sum((0, 2, 3)),
                             gf.abs().sum((0, 2, 3)))
                    for k, bound in zip((1, 2), terms):
                        e = (got[k] - want[k]).abs()
                        check(bool((e <= BN_SUM_TOL * bound).all()),
                              f"bn_act {'dscale' if k == 1 else 'dbias'} "
                              f"beyond {BN_SUM_TOL} x sum|terms|: {label}")
                        max_err["bn_act_bwd"] = max(max_err["bn_act_bwd"],
                                                    float(e.max()))
                    n_checked += 1
                    if not (n and dtype is torch.bfloat16 and act == "relu"
                            and fmt is torch.channels_last):
                        continue
                    times, host = zip(*(time_cuda(torch, fn) for fn in (
                        lambda: bn_act_forward(x, a, b, r, act),
                        lambda: bn_act_plain(x, a, b, r, act),
                        lambda: bn_act_backward(x, a, yp, g, act, res),
                        lambda: bn_act_bwd_plain(x, a, yp, g, act, res))))
                    size, vec = x.numel() * x.element_size(), 4 * c
                    ios = (2 + res, 4 + res)  # tensors read and written
                    # (scale, bias) in; (scale) in and (dscale, dbias) out
                    for name, t, t_plain, us, io, vecs, ops in (
                            ("bn_act_fwd", times[0], times[1], host[0],
                             ios[0], 2, BN_FWD_OPS),
                            ("bn_act_bwd", times[2], times[3], host[2],
                             ios[1], 3, BN_BWD_OPS)):
                        row = parts[name, res]
                        row["calls"] += n
                        row["ms"] += n * t
                        row["plain_ms"] += n * t_plain
                        row["host_ms"] += n * us / 1e3
                        row["bytes"] += n * (io * size + vecs * vec)
                        row["ops"] += n * ops * x.numel()
                    bound_ms = ((ios[0] * size + 2 * vec) / HBM_BYTES_PER_S
                                * 1e3)
                    print(f"[kernels] bn_act {shape} residual={res} x{n}/step"
                          f": fwd {times[0]:.4f} ms (plain {times[1]:.4f}, "
                          f"bytes bound {bound_ms:.4f}), bwd "
                          f"{times[2]:.4f} ms (plain {times[3]:.4f}); host "
                          f"per call: fwd {host[0]:.1f} us, bwd {host[2]:.1f} "
                          f"us ({card})")
    rows = {}
    for name, replaces in (("bn_act_fwd", ":78 and :89"),
                           ("bn_act_bwd", ":158")):
        for res in (False, True):
            part = parts[name, res]
            print(f"[kernels] {name} residual={res}: {part['calls']} calls "
                  f"a step, kernel {part['ms']:.4f} ms, plain "
                  f"{part['plain_ms']:.4f} ms, bound "
                  f"{bound_of(part['bytes'], part['ops'])[0]:.4f} ms "
                  f"({card})")
        total = {k: sum(parts[name, res][k] for res in (False, True))
                 for k in ("calls", "ms", "plain_ms", "host_ms", "bytes",
                           "ops")}
        bound_ms, bound_by = bound_of(total["bytes"], total["ops"])
        rows[name] = {"replaces": "deep_vision_tpu/ops/pallas/bn_act.py"
                                  + replaces.split()[0],
                      "max_abs_err": max_err[name], "ms": total["ms"],
                      "plain_ms": total["plain_ms"], "bound_ms": bound_ms,
                      "bound_by": bound_by}
        print(f"[kernels] {name} over one step's {total['calls']} calls "
              f"(replaces bn_act.py{replaces}): kernel {total['ms']:.4f} "
              f"ms, plain {total['plain_ms']:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}); max_abs_err {max_err[name]:.3e}; library: "
              f"none (no single PyTorch call computes act(x * a + b + r) "
              f"or its backward) ({card})")
        wrapper = "bn_act_forward" if name == "bn_act_fwd" else \
            "bn_act_backward"
        print(f"[kernels] host cost of {wrapper} over one step's "
              f"{total['calls']} calls: {total['host_ms']:.4f} ms "
              f"({1e3 * total['host_ms'] / total['calls']:.1f} us a call; "
              f"the host clock around each call, not in the device "
              f"times above) ({card})")
    print(f"[kernels] bn_act: {n_checked} cases, forward/dx/dres equal, "
          f"dscale/dbias within {BN_SUM_TOL} x sum|terms|")
    return rows


def norm_input(torch, dev, shape, dtype, case, gen):
    """A seeded input: normal draws; "offset": mean 30, std 1;
    "constant": every other channel of a 4-D input, every other row
    otherwise, 0.75 (exact sums, variance 0). 4-D inputs channels_last."""
    x = torch.randn(shape, generator=gen, device=dev)
    if case == "offset":
        x += 30.0
    elif case == "constant" and len(shape) == 4:
        x[:, ::2] = 0.75
    elif case == "constant":
        x[..., ::2, :] = 0.75
    x = x.to(dtype)
    if len(shape) == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def bound_of(nbytes, ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes at
    HBM_BYTES_PER_S and the float32 operations at FP32_FLOPS."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def moments_cases(torch, dev, calls, card):
    """Phase 3 for the BatchNorm moments: every shape of `calls` (the
    flagship step's BatchNorms) in bf16, channels_last, and the first
    three in f32, then the edge cases. E[x] and E[x^2] within
    NORM_SUM_TOL x mean |terms| per channel of the plain version, both
    errors against a float64 sum printed; the backward bit for bit; both
    bit for bit on a second call. The main path's shapes are timed.
    Returns the kernels line's fields for bn_moments_fwd and
    bn_moments_bwd, times summed over one step's calls."""
    from deep_vision_tpu_torch.ops.cuda.norm import (
        bn_moments_backward,
        bn_moments_bwd_coefficients,
        bn_moments_bwd_plain,
        bn_moments_forward,
        bn_moments_plain,
        moments_rows,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    step = sorted(calls.items())
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(shape, bf16, "normal", n) for shape, n in step]
    cases += [(shape, f32, "normal", 0) for shape, _ in step[:3]]
    cases += [((16, 64, 56, 56), bf16, "offset", 0),
              ((16, 64, 56, 56), f32, "offset", 0),
              ((8, 256, 14, 14), bf16, "constant", 0),
              ((8, 256, 14, 14), f32, "constant", 0),
              ((1, 64), bf16, "normal", 0),
              ((1, 2048, 1, 1), f32, "normal", 0),
              ((32, 100, 7, 9), bf16, "normal", 0),
              ((32, 100, 7, 9), f32, "normal", 0),
              ((4096, 384), bf16, "normal", 0), ((128, 3, 8, 8), f32,
                                                  "offset", 0)]
    tot = {name: dict(calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                      host_ms=0.0, bytes=0, ops=0)
           for name in ("bn_moments_fwd", "bn_moments_bwd")}
    max_err = {"bn_moments_fwd": 0.0, "bn_moments_bwd": 0.0}
    worst_f64 = {"kernel": 0.0, "plain": 0.0}
    for shape, dtype, case, n in cases:
        x = norm_input(torch, dev, shape, dtype, case, gen)
        rows, c = moments_rows(x), shape[1]
        got, again = bn_moments_forward(x), bn_moments_forward(x)
        want = bn_moments_plain(x)
        xd = (x.permute(0, 2, 3, 1).reshape(rows, c) if x.dim() == 4
              else x).double()
        errs = []
        for k, (terms, ref) in enumerate((
                (xd.abs().sum(0), xd.sum(0)),
                (xd.square().sum(0), xd.square().sum(0)))):
            label = f"{shape} {dtype} {case} {'E[x]' if k == 0 else 'E[x^2]'}"
            check(torch.equal(got[k], again[k]),
                  f"bn_moments forward does not repeat: {label}")
            e = (got[k].double() - want[k].double()).abs() * rows
            check(bool((e <= NORM_SUM_TOL * terms).all()),
                  f"bn_moments beyond {NORM_SUM_TOL} x sum|terms|: {label}")
            share = {who: float(((v.double() * rows - ref).abs()
                                 / terms.clamp_min(1e-300)).max())
                     for who, v in (("kernel", got[k]), ("plain", want[k]))}
            for who in share:
                worst_f64[who] = max(worst_f64[who], share[who])
            errs.append(f"{'E[x]' if k == 0 else 'E[x^2]'}: kernel "
                        f"{share['kernel']:.2e}, plain {share['plain']:.2e}")
            if n:
                max_err["bn_moments_fwd"] = max(
                    max_err["bn_moments_fwd"],
                    float((got[k] - want[k]).abs().max()))
        u = torch.randn(c, generator=gen, device=dev)
        w = torch.randn(c, generator=gen, device=dev)
        dx = bn_moments_backward(x, u, w)
        coef = bn_moments_bwd_coefficients(rows, u, w)
        check(torch.equal(dx, bn_moments_bwd_plain(x, *coef))
              and dx.stride() == x.stride()
              and torch.equal(dx, bn_moments_backward(x, u, w)),
              f"bn_moments backward differs: {shape} {dtype} {case}")
        print(f"[kernels] bn_moments {shape} {dtype} {case}: forward within "
              f"{NORM_SUM_TOL} x sum|terms| of the plain version, error "
              f"against a float64 sum as a share of sum|terms|: "
              f"{'; '.join(errs)}; backward equal; both repeat bitwise")
        if n:
            # the library's dx = alpha + beta * x: one broadcast addcmul,
            # f32 by type promotion, written into a tensor like x
            chan = (1, -1) + (1,) * (x.dim() - 2)
            alpha, beta = (t.view(chan)
                           for t in bn_moments_bwd_coefficients(rows, u, w))
            times, host = zip(*(time_cuda(torch, fn) for fn in (
                lambda: bn_moments_forward(x),
                lambda: bn_moments_plain(x),
                lambda: torch.batch_norm_stats(x, 1e-5),
                lambda: bn_moments_backward(x, u, w),
                lambda: bn_moments_bwd_plain(
                    x, *bn_moments_bwd_coefficients(rows, u, w)),
                lambda: torch.addcmul(alpha, beta, x,
                                      out=torch.empty_like(x)))))
            size = x.numel() * x.element_size()
            for name, t, us, plain, lib, nbytes, ops in (
                    ("bn_moments_fwd", times[0], host[0], times[1],
                     times[2], size + 8 * c, MOMENTS_FWD_OPS * x.numel()),
                    ("bn_moments_bwd", times[3], host[3], times[4],
                     times[5], 2 * size + 8 * c,
                     MOMENTS_BWD_OPS * x.numel())):
                row = tot[name]
                row["calls"] += n
                row["ms"] += n * t
                row["host_ms"] += n * us / 1e3
                row["plain_ms"] += n * plain
                row["library_ms"] += n * lib
                row["bytes"] += n * nbytes
                row["ops"] += n * ops
            print(f"[kernels] bn_moments {shape} x{n}/step: fwd "
                  f"{times[0]:.4f} ms (plain {times[1]:.4f}, "
                  f"torch.batch_norm_stats {times[2]:.4f}, bytes bound "
                  f"{bound_of(size + 8 * c, 0)[0]:.4f}), bwd "
                  f"{times[3]:.4f} ms (plain {times[4]:.4f}, torch.addcmul "
                  f"{times[5]:.4f}, bytes bound "
                  f"{bound_of(2 * size + 8 * c, 0)[0]:.4f}) ({card})")
        del x, xd, got, again, want, dx
    fields = {}
    for name in ("bn_moments_fwd", "bn_moments_bwd"):
        row = tot[name]
        bound_ms, bound_by = bound_of(row["bytes"], row["ops"])
        library = row["library_ms"]
        fields[name] = {
            "replaces": "deep_vision_tpu/nn/layers.py:129-137",
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library}
        print(f"[kernels] {name} over one step's {row['calls']} calls "
              f"(replaces the XLA fusion of nn/layers.py:129-137): kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / row['ms']:.1f}% of the bound; library "
              f"{LIBRARY_CALL[name]} {library:.4f} ms; host "
              f"{1e3 * row['host_ms'] / row['calls']:.1f} us a call (the "
              f"host clock around each wrapper call) ({card})")
    print(f"[kernels] bn_moments: {len(cases)} cases; worst error against "
          f"a float64 sum, as a share of sum|terms|: kernel "
          f"{worst_f64['kernel']:.3e}, plain {worst_f64['plain']:.3e}")
    return fields


def ln_share(torch, got, want, bf16_result, k):
    """The worst share of LayerNorm's tolerance: |got - want| <= tol x
    (|want| + max |want|), tol = (BF16_ULP if bf16_result) + LN_TOL k."""
    tol = (BF16_ULP if bf16_result else 0.0) + LN_TOL * k
    got, want = got.double(), want.double()
    allowed = tol * (want.abs() + want.abs().max())
    return float(((got - want).abs() / allowed.clamp_min(1e-300)).max())


def layer_norm_cases(torch, dev, card):
    """Phase 3 for LayerNorm: the ViT step's shapes (64 x 1024 rows of
    384: bf16 in and out for the 24 block LayerNorms, f32 for the final
    one), then the edge cases. y, mean, rstd and dx within ln_share's
    tolerance, dscale and dbias within NORM_SUM_TOL x k x sum |terms|,
    all bit for bit on a second call. The main path's shapes are timed.
    Returns the kernels line's fields for layer_norm_fwd and
    layer_norm_bwd, times summed over one step's calls."""
    import torch.nn.functional as F

    from deep_vision_tpu_torch.ops.cuda.norm import (
        layer_norm_backward,
        layer_norm_bwd_plain,
        layer_norm_forward,
        layer_norm_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    step = (VIT_BATCH, (VIT_IMAGE // 16) ** 2, 384)
    cases = [(step, bf16, bf16, "normal", 24), (step, f32, f32, "normal", 1),
             ((8, 1024, 384), bf16, bf16, "offset", 0),
             ((8, 1024, 384), f32, f32, "offset", 0),
             ((8, 1024, 384), bf16, bf16, "constant", 0),
             ((8, 1024, 384), f32, f32, "constant", 0),
             ((1, 384), bf16, bf16, "normal", 0),
             ((1, 384), f32, f32, "normal", 0),
             ((7, 384), bf16, f32, "normal", 0),
             ((64, 197, 100), bf16, bf16, "normal", 0),
             ((64, 197, 100), f32, f32, "normal", 0),
             ((16, 196, 768), bf16, bf16, "normal", 0)]
    tot = {name: dict(calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                      host_ms=0.0, bytes=0, ops=0)
           for name in ("layer_norm_fwd", "layer_norm_bwd")}
    max_err = {"layer_norm_fwd": 0.0, "layer_norm_bwd": 0.0}
    for shape, dtype, out, case, n in cases:
        d = shape[-1]
        x = norm_input(torch, dev, shape, dtype, case, gen)
        s = torch.rand(d, generator=gen, device=dev) + 0.5
        b = torch.randn(d, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev).to(out)
        xd = x.double()
        k = float((xd.square().mean(-1) / (xd.var(-1, unbiased=False)
                                           + 1e-6)).max())
        label = f"{shape} {dtype} -> {out} {case}"
        y, mean, rstd = layer_norm_forward(x, s, b, 1e-6, out)
        wy, wmean, wrstd = layer_norm_plain(x, s, b, 1e-6, out)
        shares = {"y": ln_share(torch, y, wy, out == bf16, k),
                  "mean": ln_share(torch, mean, wmean, False, k),
                  "rstd": ln_share(torch, rstd, wrstd, False, k)}
        dx, ds, db = layer_norm_backward(x, s, wmean, wrstd, g)
        wdx, wds, wdb = layer_norm_bwd_plain(x, s, wmean, wrstd, g)
        shares["dx"] = ln_share(torch, dx, wdx, dtype == bf16, k)
        xhat = (xd - wmean.double()[..., None]) * wrstd.double()[..., None]
        rows = tuple(range(x.dim() - 1))
        for name, got, want, terms in (
                ("dscale", ds, wds, (g.double() * xhat).abs().sum(rows)),
                ("dbias", db, wdb, g.double().abs().sum(rows))):
            bound = NORM_SUM_TOL * k * terms
            shares[name] = float(((got.double() - want.double()).abs()
                                  / bound.clamp_min(1e-300)).max())
        again = (*layer_norm_forward(x, s, b, 1e-6, out),
                 *layer_norm_backward(x, s, wmean, wrstd, g))
        check(all(torch.equal(a, w) for a, w in zip(
            (y, mean, rstd, dx, ds, db), again)),
              f"layer_norm does not repeat bitwise: {label}")
        worst = max(shares.values())
        rounded = {m: float(f"{v:.3g}") for m, v in shares.items()}
        print(f"[kernels] layer_norm {label} (k {k:.3g}): shares of the "
              f"tolerance {rounded}; repeats bitwise")
        check(worst <= 1.0, f"layer_norm beyond tolerance: {label}: "
              f"{shares}")
        if n:
            max_err["layer_norm_fwd"] = max(
                max_err["layer_norm_fwd"],
                float((y.float() - wy.float()).abs().max()))
            max_err["layer_norm_bwd"] = max(
                max_err["layer_norm_bwd"],
                float((dx.float() - wdx.float()).abs().max()),
                float((ds - wds).abs().max()), float((db - wdb).abs().max()))
            xl = x.detach().requires_grad_()
            wl = s.to(dtype).requires_grad_()
            bl = b.to(dtype).requires_grad_()
            yl = F.layer_norm(xl, (d,), wl, bl, 1e-6)
            gl = g.to(yl.dtype)
            times, host = zip(*(time_cuda(torch, fn) for fn in (
                lambda: layer_norm_forward(x, s, b, 1e-6, out),
                lambda: layer_norm_plain(x, s, b, 1e-6, out),
                lambda: F.layer_norm(x, (d,), wl, bl, 1e-6),
                lambda: layer_norm_backward(x, s, wmean, wrstd, g),
                lambda: layer_norm_bwd_plain(x, s, wmean, wrstd, g),
                lambda: torch.autograd.grad(yl, (xl, wl, bl), gl,
                                            retain_graph=True))))
            nrows = x.numel() // d
            xb, yb = x.numel() * x.element_size(), y.numel() * y.element_size()
            for name, t, us, plain, lib, nbytes, ops in (
                    ("layer_norm_fwd", times[0], host[0], times[1], times[2],
                     xb + yb + 8 * d + 8 * nrows, LN_FWD_OPS * x.numel()),
                    ("layer_norm_bwd", times[3], host[3], times[4], times[5],
                     2 * xb + yb + 12 * d + 8 * nrows,
                     LN_BWD_OPS * x.numel())):
                row = tot[name]
                row["calls"] += n
                row["ms"] += n * t
                row["host_ms"] += n * us / 1e3
                row["plain_ms"] += n * plain
                row["library_ms"] += n * lib
                row["bytes"] += n * nbytes
                row["ops"] += n * ops
            print(f"[kernels] layer_norm {label} x{n}/step: fwd "
                  f"{times[0]:.4f} ms (plain {times[1]:.4f}, F.layer_norm "
                  f"{times[2]:.4f}), bwd {times[3]:.4f} ms (plain "
                  f"{times[4]:.4f}, F.layer_norm backward {times[5]:.4f}) "
                  f"({card})")
            del xl, wl, bl, yl, gl
        del x, xd, xhat, g, y, wy, dx, wdx, again
    fields = {}
    for name in ("layer_norm_fwd", "layer_norm_bwd"):
        row = tot[name]
        bound_ms, bound_by = bound_of(row["bytes"], row["ops"])
        fields[name] = {
            "replaces": "deep_vision_tpu/models/vit.py:156",
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": row["library_ms"]}
        library = ("forward" if name == "layer_norm_fwd"
                   else "backward")
        print(f"[kernels] {name} over one step's {row['calls']} calls "
              f"(replaces flax's LayerNorm, vit.py:156, :158, :225): kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / row['ms']:.1f}% of the bound; "
              f"F.layer_norm {library} {row['library_ms']:.4f} ms; host "
              f"{1e3 * row['host_ms'] / row['calls']:.1f} us a call ({card})")
    print(f"[kernels] layer_norm: {len(cases)} cases within tolerance")
    return fields


def flash_case_list():
    """(label, B, T, Tk, H, D, causal, score scale) for phase 3."""
    b, t, h, d = VIT_BATCH, (VIT_IMAGE // 16) ** 2, 6, 64
    return [
        ("the ViT step's shape", b, t, t, h, d, False, 1.0),
        ("causal", 8, t, t, h, d, True, 1.0),
        ("cross Tq 256, Tk 1024", 8, 256, t, h, d, False, 1.0),
        ("ragged T 1000", 8, 1000, 1000, h, d, False, 1.0),
        ("ragged T 77, causal", 16, 77, 77, h, d, True, 1.0),
        ("D 32", 8, 512, 512, 4, 32, False, 1.0),
        ("D 128, causal", 8, 512, 512, 4, 128, True, 1.0),
        ("scores x120, causal", 8, t, t, h, d, True, 120.0),
        ("T 129, Tk 65", 8, 129, 65, h, d, False, 1.0),
        ("a single query, Tk 1024", 8, 1, t, h, d, False, 1.0),
        ("causal cross Tq 256, Tk 1024", 8, 256, t, h, d, True, 1.0),
    ]


def flash_inputs(torch, dev, b, t, tk, h, d, dtype, gen, qk_scale=1.0):
    """q, k, v as the ViT's qkv projection gives them (strided views of
    one (B, T, 3, H, D) tensor) when T == Tk, else separate tensors; and
    a contiguous output gradient."""
    if t == tk:
        qkv = torch.randn(b, t, 3, h, d, generator=gen, device=dev)
        qkv[:, :, 0] *= qk_scale
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q, k, v = (torch.randn(b, n, h, d, generator=gen, device=dev).to(
            dtype) for n in (t, tk, tk))
        q = q * qk_scale
    return q, k, v, torch.randn(b, t, h, d, generator=gen, device=dev).to(
        dtype)


def flash_error(torch, got, want, kind, part):
    """(max |got - want|, worst share of the tolerance used)."""
    rtol, atol, relative = FLASH_TOL[kind, part]
    got, want = got.float(), want.float()
    if relative:
        atol *= float(want.abs().max())
    err = (got - want).abs()
    return float(err.max()), float((err / (atol + rtol * want.abs())).max())


def flash_cases(torch, dev, card):
    """Phase 3 for flash attention: every case of flash_case_list() in
    f32 and bf16, kernel against plain version within FLASH_TOL: the
    forward (out and lse), then dq/dk/dv from the plain forward's out and
    lse, without and with an lse cotangent. Then, at the ViT step's
    shape in bf16, the kernel, plain, bound and
    scaled_dot_product_attention times. Returns the kernels line's
    fields for flash_fwd, flash_dq and flash_dkv."""
    from deep_vision_tpu_torch.ops.cuda.flash_attention import (
        flash_backward,
        flash_bwd_plain,
        flash_delta,
        flash_dkv,
        flash_dkv_plain,
        flash_dq,
        flash_dq_plain,
        flash_forward,
        flash_fwd_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    # max |kernel - plain| at the main path's inputs (the step's shape,
    # bf16); every case's errors are printed
    max_err = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for i, (label, b, t, tk, h, d, causal, qk_scale) in enumerate(
            flash_case_list()):
        for dtype in (torch.float32, torch.bfloat16):
            main_path = i == 0 and dtype is torch.bfloat16
            kind = ("bf16" if dtype is torch.bfloat16
                    else "x120" if qk_scale != 1.0 else "f32")
            q, k, v, g = flash_inputs(torch, dev, b, t, tk, h, d, dtype, gen,
                                      qk_scale)
            scale = d ** -0.5
            out, lse = flash_forward(q, k, v, causal=causal)
            want_out, want_lse = flash_fwd_plain(q, k, v, causal, scale)
            errs = {"out": flash_error(torch, out, want_out, kind, "out"),
                    "lse": flash_error(torch, lse, want_lse, "lse", "out")}
            if main_path:
                max_err["flash_fwd"] = errs["out"][0]
            shift = torch.randn(b, h, t, generator=gen, device=dev)
            for tag, delta_shift in (("", None), (" lse-cot", shift)):
                got = flash_backward(q, k, v, want_out, want_lse, g,
                                     causal=causal, delta_shift=delta_shift)
                want = flash_bwd_plain(q, k, v, want_out, want_lse, g, causal,
                                       scale, delta_shift)
                for name, a, w in zip(("dq", "dk", "dv"), got, want):
                    errs[name + tag] = flash_error(torch, a, w, kind, "grad")
                    key = "flash_dq" if name == "dq" else "flash_dkv"
                    if main_path:
                        max_err[key] = max(max_err[key], errs[name + tag][0])
                del got, want
            torch.cuda.synchronize()
            worst = max(e[1] for e in errs.values())
            print(f"[kernels] flash {label} (B {b}, T {t}, Tk {tk}, H {h}, "
                  f"D {d}) {dtype}: max |err| "
                  f"{ {n: float(f'{e[0]:.3e}') for n, e in errs.items()} }; "
                  f"worst {worst:.3f} of the tolerance")
            check(worst <= 1.0, f"flash kernel beyond tolerance: {label} "
                  f"{dtype}: {errs}")
            del q, k, v, g, out, lse, want_out, want_lse
            torch.cuda.empty_cache()

    # times at the step's shape, bf16: the kernels, the plain versions and
    # the library's fused attention (timed only; the port never calls it)
    _, b, t, tk, h, d, causal, _ = flash_case_list()[0]
    q, k, v, g = flash_inputs(torch, dev, b, t, tk, h, d, torch.bfloat16,
                              gen)
    scale = d ** -0.5
    out, lse = flash_forward(q, k, v)
    delta = flash_delta(out, g)
    times = {}
    for name, fn in (
            ("fwd", lambda: flash_forward(q, k, v)),
            ("fwd_plain", lambda: flash_fwd_plain(q, k, v, False, scale)),
            ("dq", lambda: flash_dq(q, k, v, g, lse, delta)),
            ("dq_plain", lambda: flash_dq_plain(q, k, v, g, lse, delta,
                                                False, scale)),
            ("dkv", lambda: flash_dkv(q, k, v, g, lse, delta)),
            ("dkv_plain", lambda: flash_dkv_plain(q, k, v, g, lse, delta,
                                                  False, scale))):
        times[name] = time_cuda(torch, fn)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    times["sdpa_fwd"] = time_cuda(torch, lambda: sdpa(qt, kt, vt))
    o_sdpa = sdpa(qt, kt, vt)
    g_sdpa = g.transpose(1, 2)
    times["sdpa_bwd"] = time_cuda(torch, lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), g_sdpa, retain_graph=True))
    check(torch.allclose(o_sdpa.transpose(1, 2).float(), out.float(),
                         rtol=2e-2, atol=2e-2),
          "scaled_dot_product_attention disagrees with the flash kernel")
    pairs = b * h * t * tk
    qkvo = b * t * h * d * q.element_size()
    rows = b * h * t * 4  # one f32 per (b, h, query)
    work = {  # (flops, exponentials, bytes: inputs read, outputs written)
        "flash_fwd": (4 * pairs * d, pairs, 4 * qkvo + rows),
        "flash_dq": (6 * pairs * d, pairs, 5 * qkvo + 2 * rows),
        "flash_dkv": (8 * pairs * d, pairs, 6 * qkvo + 2 * rows),
    }
    fields = {}
    for name, kernel, plain, library, replaces in (
            ("flash_fwd", "fwd", "fwd_plain", "sdpa_fwd", ":85"),
            ("flash_dq", "dq", "dq_plain", "sdpa_bwd", ":192"),
            ("flash_dkv", "dkv", "dkv_plain", "sdpa_bwd", ":232")):
        flops, exps, nbytes = work[name]
        terms = {"tensor cores": flops / BF16_FLOPS * 1e3,
                 "exponentials": exps / EXP_PER_S * 1e3,
                 "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        by = max(terms, key=terms.get)
        fields[name] = {
            "replaces": "deep_vision_tpu/ops/pallas/flash_attention.py"
                        + replaces,
            "max_abs_err": max_err[name], "ms": times[kernel][0],
            "plain_ms": times[plain][0], "bound_ms": terms[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "library_ms": times[library][0]}
        print(f"[kernels] {name} at (B {b}, T {t}, H {h}, D {d}) bf16, one "
              f"call: kernel {times[kernel][0]:.4f} ms, plain "
              f"{times[plain][0]:.4f} ms, bound {terms[by]:.4f} ms ({by}; "
              f"{ {n: round(v, 4) for n, v in terms.items()} }: {flops} "
              f"flops, {exps} exponentials, {nbytes} bytes), "
              f"{100 * terms[by] / times[kernel][0]:.1f}% of the bound; "
              f"scaled_dot_product_attention "
              f"{'forward' if library == 'sdpa_fwd' else 'backward (dq, dk and dv together)'} "
              f"{times[library][0]:.4f} ms; host {times[kernel][1]:.1f} us "
              f"a call ({card})")
    print(f"[kernels] flash backward, dq + dkv: "
          f"{times['dq'][0] + times['dkv'][0]:.4f} ms against "
          f"scaled_dot_product_attention's backward "
          f"{times['sdpa_bwd'][0]:.4f} ms ({card})")
    del q, k, v, g, out, lse, delta, qt, kt, vt, o_sdpa
    torch.cuda.empty_cache()
    return fields


def vit_phase(torch, dev, card):
    """Phase 5 for the ViT: the ViT-S/16 512 bf16 batch-64 step through
    the Trainer. Returns the flash launch counts of its run."""
    from deep_vision_tpu_torch.ops.cuda.flash_attention import flash_attention
    from deep_vision_tpu_torch.ops.cuda.norm import layer_norm
    from deep_vision_tpu_torch.tools.profile_train import make_vit_train_parts

    trainer, batch = make_vit_train_parts(VIT_BATCH, VIT_IMAGE, device=dev)
    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    flash_attention.launches = 0  # the ViT training path's run starts here
    flash_attention.dq_launches = 0
    flash_attention.dkv_launches = 0
    layer_norm.launches = 0
    layer_norm.backward_launches = 0
    losses, events, lrs = [], [], []
    for i in range(steps):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batch)["loss"])
        end.record()
        events.append((start, end))
        lrs.append(trainer.state.optimizer.param_groups[0]["lr"])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches = {"flash_fwd": flash_attention.launches,
                "flash_dq": flash_attention.dq_launches,
                "flash_dkv": flash_attention.dkv_launches,
                "layer_norm_fwd": layer_norm.launches,
                "layer_norm_bwd": layer_norm.backward_launches}
    # ... and ends here
    step_ms = statistics.median(s.elapsed_time(e)
                                for s, e in events[WARMUP_STEPS:])
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[train] ViT-S/16 {VIT_IMAGE}x{VIT_IMAGE} bf16 ({n_params} "
          f"parameters) batch {VIT_BATCH}: {step_ms:.3f} ms/step median of "
          f"{TIMED_STEPS} (CUDA events; wall {wall_ms:.3f} ms/step), "
          f"{VIT_BATCH / step_ms * 1e3:.1f} images/s, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({card})")
    print(f"[train] ViT loss by step {[round(v, 4) for v in losses]}; lr by "
          f"step {[float(f'{v:.3e}') for v in lrs]}; flash and LayerNorm "
          f"launches {launches} over {steps} steps")
    check(n_params == 22_367_848, f"ViT-S/16 at 512 has {n_params} params")
    check(launches == {k: (25 if k.startswith("layer_norm") else 12) * steps
                       for k in launches},
          f"launches {launches}, want 12 + 12 + 12 flash and 25 + 25 "
          f"LayerNorm per step")
    check(all(np.isfinite(losses)), "non-finite ViT loss")
    check(losses[-1] < losses[WARMUP_STEPS],
          "the ViT loss did not fall over the timed steps on a fixed batch")
    del trainer, batch
    torch.cuda.empty_cache()
    return launches


def check_vit_dense_route(torch, dev):
    """A 224x224 vit_s16 eval forward (196 tokens) takes the dense
    einsum: no flash launch."""
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.ops.cuda.flash_attention import flash_attention

    model = get_model("vit_s16", dtype=torch.bfloat16, device=dev)
    images = torch.from_numpy(np.random.RandomState(1).rand(
        8, 224, 224, 3).astype(np.float32)).to(dev)
    before = (flash_attention.launches, flash_attention.dq_launches,
              flash_attention.dkv_launches)
    with torch.no_grad():
        logits = model(images)
    torch.cuda.synchronize()
    after = (flash_attention.launches, flash_attention.dq_launches,
             flash_attention.dkv_launches)
    print(f"[train] vit_s16 224x224 eval forward, batch 8: logits "
          f"{tuple(logits.shape)}, flash launches {after[0] - before[0]} "
          f"(dense route)")
    check(after == before, "the 224x224 ViT launched a flash kernel")
    check(bool(torch.isfinite(logits).all()), "non-finite 224 logits")
    del model


def check_vit_against_cpu(torch, dev):
    """One float32 ViT-S/16 512 step at batch VIT_CHECK_BATCH on the card
    (kernels) and on the CPU (plain versions), from the same seeded
    weights and batch: loss, grad norm and each parameter's gradient
    within VIT_CHECK_TOL. (The first AdamW update is not compared: it is
    about lr * g / (|g| + eps), so a rounding difference in a gradient
    near 0 becomes a full-size difference.)"""
    from deep_vision_tpu_torch.ops.cuda.flash_attention import flash_attention
    from deep_vision_tpu_torch.tools.profile_train import make_vit_train_parts

    from deep_vision_tpu_torch.ops.cuda.norm import layer_norm

    runs = {}
    for where in (dev, torch.device("cpu")):
        before = (flash_attention.launches, layer_norm.launches,
                  layer_norm.backward_launches)
        trainer, batch = make_vit_train_parts(
            VIT_CHECK_BATCH, VIT_IMAGE, device=where, dtype=torch.float32)
        start = {k: v.detach().cpu().clone()
                 for k, v in trainer.model.state_dict().items()}
        metrics = trainer.train_step(batch)
        grads = {n: p.grad.detach().cpu()
                 for n, p in trainer.model.named_parameters()}
        runs[where.type] = (float(metrics["loss"]),
                            float(metrics["grad_norm"]), start, grads,
                            (flash_attention.launches - before[0],
                             layer_norm.launches - before[1],
                             layer_norm.backward_launches - before[2]))
        del trainer, batch
    (lk, gk, sk, dk, nk), (lp, gp, sp, dp, np_) = runs["cuda"], runs["cpu"]
    check(min(nk) > 0 and max(np_) == 0,
          f"flash, LayerNorm and LayerNorm-backward launches card {nk}, cpu "
          f"{np_}")
    check(all(torch.equal(sk[k], sp[k]) for k in sp),
          "the card and CPU steps did not start from the same weights")
    worst = {"loss": abs(lk - lp) / abs(lp),
             "grad_norm": abs(gk - gp) / abs(gp), "grad": 0.0}
    where = ""
    for k in dp:
        e = float((dk[k] - dp[k]).abs().max()) / max(
            float(dp[k].abs().max()), 1e-30)
        if e > worst["grad"]:
            worst["grad"], where = e, k
    print(f"[train] ViT float32 batch {VIT_CHECK_BATCH}, card vs CPU: loss "
          f"{lk:.6f} vs {lp:.6f}, grad_norm {gk:.6f} vs {gp:.6f}; worst "
          f"relative errors {worst} (gradient: {where}); tolerances "
          f"{VIT_CHECK_TOL}")
    for kind, e in worst.items():
        check(e <= VIT_CHECK_TOL[kind], f"ViT card vs CPU {kind} error "
              f"{e:.3e} > {VIT_CHECK_TOL[kind]}")


def train_phase(torch, trainer, batch, card):
    """Phase 5: the flagship step through the Trainer. Returns the
    bn_act launch counts of its run."""
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments

    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fused_scale_bias_act.launches = 0  # the training path's run starts here
    fused_scale_bias_act.backward_launches = 0
    batch_moments.launches = 0
    batch_moments.backward_launches = 0
    losses, events = [], []
    for i in range(steps):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batch)["loss"])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    launches = {"bn_act_fwd": fused_scale_bias_act.launches,
                "bn_act_bwd": fused_scale_bias_act.backward_launches,
                "bn_moments_fwd": batch_moments.launches,
                "bn_moments_bwd": batch_moments.backward_launches}
    # ... and ends here
    step_ms = statistics.median(s.elapsed_time(e)
                                for s, e in events[WARMUP_STEPS:])
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[train] ResNet-50 s2d bf16 ({n_params} parameters) batch "
          f"{TRAIN_BATCH}: {step_ms:.3f} ms"
          f"/step median of {TIMED_STEPS} (CUDA events; wall "
          f"{wall_ms:.3f} ms/step), {TRAIN_BATCH / step_ms * 1e3:.1f} "
          f"images/s, max_memory_allocated {peak / 2**30:.2f} GiB ({card})")
    print(f"[train] loss by step {[round(v, 4) for v in losses]}; bn_act "
          f"and moments launches {launches} over {steps} steps")
    check(launches == {"bn_act_fwd": 48 * steps, "bn_act_bwd": 48 * steps,
                       "bn_moments_fwd": 53 * steps,
                       "bn_moments_bwd": 53 * steps},
          f"launches {launches}, want 48 + 48 bn_act and 53 + 53 moments "
          f"per step")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[WARMUP_STEPS],
          "the loss did not fall over the timed steps on a fixed batch")
    return launches


def check_against_cpu(torch, dev):
    """One float32 step at batch CHECK_BATCH on the card (kernels) and on
    the CPU (plain versions), from the same seeded weights and batch:
    loss, grad norm, every parameter's update and every running
    statistic within CHECK_TOL."""
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments
    from deep_vision_tpu_torch.tools.profile_train import make_train_parts

    runs = {}
    for where in (dev, torch.device("cpu")):
        before_fwd = (fused_scale_bias_act.launches, batch_moments.launches,
                      batch_moments.backward_launches)
        trainer, batch = make_train_parts(CHECK_BATCH, "s2d", device=where,
                                          dtype=torch.float32)
        sd = trainer.model.state_dict()
        before = {k: v.detach().cpu().clone() for k, v in sd.items()}
        metrics = trainer.train_step(batch)
        after = {k: v.detach().cpu() for k, v in sd.items()}
        runs[where.type] = (float(metrics["loss"]),
                            float(metrics["grad_norm"]), before, after,
                            (fused_scale_bias_act.launches - before_fwd[0],
                             batch_moments.launches - before_fwd[1],
                             batch_moments.backward_launches
                             - before_fwd[2]),
                            {n for n, _ in trainer.model.named_parameters()})
        del trainer, batch
    (lk, gk, bk, ak, nk, params), (lp, gp, bp, ap, np_, _) = (
        runs["cuda"], runs["cpu"])
    check(min(nk) > 0 and max(np_) == 0,
          f"bn_act, moments and moments-backward launches card {nk}, cpu "
          f"{np_}")
    check(all(torch.equal(bk[k], bp[k]) for k in bp),
          "the card and CPU steps did not start from the same weights")
    worst = {"loss": abs(lk - lp) / abs(lp),
             "grad_norm": abs(gk - gp) / abs(gp), "update": 0.0,
             "stats": 0.0}
    where = {}
    for k in bp:
        if k in params:
            du_k, du_p = ak[k] - bk[k], ap[k] - bp[k]
            e = float((du_k - du_p).abs().max()) / max(
                float(du_p.abs().max()), 1e-30)
            kind = "update"
        else:
            e = float((ak[k] - ap[k]).abs().max()) / max(
                float(ap[k].abs().max()), 1e-30)
            kind = "stats"
        if e > worst[kind]:
            worst[kind], where[kind] = e, k
    print(f"[train] float32 batch {CHECK_BATCH}, card vs CPU: loss {lk:.6f} "
          f"vs {lp:.6f}, grad_norm {gk:.6f} vs {gp:.6f}; worst relative "
          f"errors {worst} at {where}; tolerances {CHECK_TOL}")
    for kind, e in worst.items():
        check(e <= CHECK_TOL[kind], f"card vs CPU {kind} error {e:.3e} > "
              f"{CHECK_TOL[kind]} ({where.get(kind, kind)})")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deep_vision_tpu_torch.inference import (
        yolo_decode_outputs,
        yolo_predict_fn,
    )
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.nn.layers import calibrate_batch_stats
    from deep_vision_tpu_torch.ops.cuda import build
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.flash_attention import flash_attention
    from deep_vision_tpu_torch.ops.cuda.nms import (
        PASS_CANDIDATES,
        greedy_nms,
        nms_plain,
        selection_plan,
    )
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments, layer_norm
    from deep_vision_tpu_torch.serve import Engine, Server
    from deep_vision_tpu_torch.tools.profile_train import make_train_parts

    dev = torch.device("cuda", 0)

    # -- 1. setup ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    print(f"[setup] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build()
    print(f"[build] {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {secs})")
    for name in secs:
        for kernel, use in sorted(build.ptxas_usage(
                build.ptxas_report(name)).items()):
            print(f"[build] {name}: {kernel}: {use['registers']} registers,"
                  f" spill stores {use['spill_stores']} B, spill loads "
                  f"{use['spill_loads']} B")
            # the Hopper flash kernels hold their tiles' products in
            # registers, the float32 ones their accumulators, and the
            # LayerNorm kernels a row a warp: a spill there is a design
            # fault, not a detail
            check(name not in ("flash_attention", "norm")
                  or use["spill_stores"] + use["spill_loads"] == 0,
                  f"{kernel} spills")

    # -- 3. kernels against plain versions -----------------------------------
    check_nms(torch, dev)

    trainer, train_batch = make_train_parts(TRAIN_BATCH, "s2d", device=dev)
    calls, moment_calls = batchnorm_calls(torch, trainer.model,
                                          train_batch["image"])
    check(sum(calls.values()) == 48,
          f"the flagship step should make 48 bn_act calls, got {calls}")
    check(sum(moment_calls.values()) == 53,
          f"the flagship step should take 53 batch moments, got "
          f"{moment_calls}")
    bn_rows = bn_act_cases(torch, dev, calls, card)
    torch.cuda.empty_cache()
    norm_rows = moments_cases(torch, dev, moment_calls, card)
    torch.cuda.empty_cache()
    norm_rows.update(layer_norm_cases(torch, dev, card))
    torch.cuda.empty_cache()
    flash_rows = flash_cases(torch, dev, card)

    # -- 4. serving ----------------------------------------------------------
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    model = get_model("yolov3", num_classes=NUM_CLASSES, seed=0)
    calib = torch.from_numpy(
        rng.rand(8, IMAGE, IMAGE, 3).astype(np.float32)).to(dev)
    calibrate_batch_stats(model, calib)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] YOLOv3 {IMAGE}x{IMAGE} {NUM_CLASSES} classes, "
          f"{n_params} parameters, built in {time.perf_counter() - t0:.2f} s")
    det = dict(max_detections=MAX_DET, iou_threshold=IOU_THR,
               score_threshold=SCORE_THR)
    engine = Engine()
    engine.register("yolov3", yolo_predict_fn(model, **det),
                    model.state_dict(), input_shape=(IMAGE, IMAGE, 3),
                    buckets=BUCKETS)
    warm = engine.warmup()
    print(f"[serve] warmup {warm['pairs']} buckets in "
          f"{warm['warmup_ms_total']:.1f} ms")
    server = Server(engine, max_wait_ms=5.0).start()

    requests = [rng.rand(IMAGE, IMAGE, 3).astype(np.float32)
                for _ in range(max(BURSTS))]
    greedy_nms.launches = 0  # the serving path's run starts here
    fused_scale_bias_act.launches = 0
    fused_scale_bias_act.backward_launches = 0
    flash_attention.launches = 0
    batch_moments.launches = 0
    layer_norm.launches = 0
    t0 = time.perf_counter()
    rows = []
    for burst in BURSTS:
        futs = [server.submit("yolov3", requests[i]) for i in range(burst)]
        rows += [f.result(timeout=300) for f in futs]
    stream_s = time.perf_counter() - t0
    launches = greedy_nms.launches  # ... and ends here
    check(fused_scale_bias_act.launches == 0, "YOLOv3 serving ran bn_act")
    check(flash_attention.launches == 0, "YOLOv3 serving ran flash")
    check(batch_moments.launches == layer_norm.launches == 0,
          "YOLOv3 serving took batch moments or ran a LayerNorm")
    slo = server.slo.report()["yolov3"]
    print(f"[serve] {len(rows)} requests in {len(BURSTS)} bursts, "
          f"{slo['batches']} batches, {stream_s:.3f} s; nms launches "
          f"{launches}")
    for row in rows:
        check(row["boxes"].shape == (MAX_DET, 4)
              and row["scores"].shape == (MAX_DET,)
              and row["classes"].shape == (MAX_DET,)
              and row["num"].shape == (), "response shapes")
        check(np.isfinite(row["boxes"]).all()
              and np.isfinite(row["scores"]).all(), "non-finite response")
        n = int(row["num"])
        check((row["classes"][:n] >= 0).all()
              and (row["classes"][n:] == -1).all(), "padding layout")
    check(launches == slo["batches"] and launches > 0,
          f"nms launches {launches} != batches {slo['batches']}")

    # one bucket-8 batch: kernel against the same predictor with plain NMS
    x = torch.from_numpy(np.stack(requests[:8])).to(dev)
    variables = engine.entry("yolov3").variables
    got = engine.run("yolov3", x)
    want = yolo_predict_fn(model, select=nms_plain, **det)(variables, x)
    for k in got:
        check(torch.equal(got[k], want[k]),
              f"served '{k}' differs from the plain-NMS predictor")
    with torch.inference_mode():
        boxes, scores = yolo_decode_outputs(model(x))
        best, cls = scores.max(dim=-1)
    above = (best >= SCORE_THR).sum(dim=1).tolist()
    kept = got["num"].tolist()
    print(f"[serve] bucket 8 vs plain-NMS predictor: equal; candidates "
          f"above {SCORE_THR} per image {above} of {best.shape[1]}; "
          f"detections per image {kept}")
    check(min(above) > 0, "the seeded model leaves no candidate")

    bucket_ms = {}
    for b in BUCKETS:
        xb = x[:b].contiguous()
        times = []
        for i in range(13):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.run("yolov3", xb)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t) * 1e3)
        bucket_ms[b] = statistics.median(times)
        print(f"[serve] Engine.run bucket {b}: {bucket_ms[b]:.3f} ms median "
              f"of 10 ({card})")
    ips = 8 / (bucket_ms[8] / 1e3)
    print(f"[serve] bucket 8: {ips:.1f} images/s ({card})")
    print(f"[serve] SLO p50 {slo['p50_ms']:.3f} ms p99 {slo['p99_ms']:.3f} ms "
          f"(histogram bucket bounds) over {slo['requests']} requests "
          f"({card})")

    summary = server.close()
    print(f"[serve] drain: {summary}")
    check(summary["outcome"] == "flushed", "drain did not flush")
    check(summary["accepted"] == summary["completed"] + summary["errors"]
          + summary["cancelled"] and summary["completed"] == len(rows),
          "drain ledger does not balance")

    # NMS at the main path's inputs: the class-shifted boxes of bucket 8
    shifted = (boxes + cls.to(boxes.dtype)[..., None] * 2.0).contiguous()
    best = best.contiguous()
    k_out = greedy_nms(shifted, best, MAX_DET, IOU_THR, SCORE_THR)
    p_out = nms_plain(shifted, best, MAX_DET, IOU_THR, SCORE_THR)
    check(torch.equal(k_out[1], p_out[1]), "nms indices at serving inputs")
    max_abs_err = float((k_out[0] - p_out[0]).abs().max())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
    try:
        greedy_nms(shifted, best, MAX_DET, IOU_THR, SCORE_THR)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms, passes, chunks = selection_plan(best, k_out[1], SCORE_THR,
                                        PASS_CANDIDATES)
    print(f"[kernels] nms at serving inputs: M per image {ms}, passes "
          f"{passes} (K {PASS_CANDIDATES}), 64-candidate chunks scanned "
          f"{chunks}, keeps {(k_out[1] >= 0).sum(dim=1).tolist()}; one "
          f"call enqueues every phase without a host sync")
    plain_ms, plain_us = time_cuda(torch, lambda: nms_plain(
        shifted, best, MAX_DET, IOU_THR, SCORE_THR))
    nms_ms, nms_us = time_cuda(torch, lambda: greedy_nms(
        shifted, best, MAX_DET, IOU_THR, SCORE_THR))
    one = (shifted[:1].contiguous(), best[:1].contiguous())
    nms1_ms, nms1_us = time_cuda(torch, lambda: greedy_nms(
        *one, MAX_DET, IOU_THR, SCORE_THR))
    nb, n = best.shape
    picks = (k_out[1] >= 0).sum(dim=1)
    rounds = int(torch.clamp(picks + (picks < MAX_DET).long(),
                             max=MAX_DET).sum())
    nbytes = nb * n * (16 + 4) + nb * MAX_DET * (4 + 4)
    ops = NMS_OPS_PER_CANDIDATE * n * rounds
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    print(f"[kernels] nms at serving inputs (B={nb}, N={n}, D={MAX_DET}): "
          f"kernel {nms_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.6f} ms ({nbytes} B, {ops} ops, {rounds} "
          f"rounds); serial chain of the scan: {sum(chunks)} chunks + "
          f"{int(picks.sum())} keeps over {nb} images in parallel (a note, "
          f"not the bound); library: none (no single PyTorch call computes "
          f"greedy NMS, and torchvision is not installed) ({card})")
    print(f"[kernels] nms at serving inputs, B=1 (N={n}, D={MAX_DET}, M "
          f"{ms[0]}): kernel {nms1_ms:.4f} ms, host {nms1_us:.1f} us a call "
          f"({card})")
    print(f"[kernels] host cost of greedy_nms: {nms_us:.1f} us a call "
          f"(plain version {plain_us:.1f} us); the host clock around each "
          f"call, not in the device times above ({card})")
    kernels = [{
        "name": "nms",
        "route": "cuda",
        "source": "deep_vision_tpu_torch/csrc/nms.cu",
        "replaces": "deep_vision_tpu/ops/pallas/nms.py:42",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": nms_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]
    del engine, model, x, variables
    torch.cuda.empty_cache()

    # -- 5. training ---------------------------------------------------------
    launches = train_phase(torch, trainer, train_batch, card)
    del trainer, train_batch
    torch.cuda.empty_cache()
    check_against_cpu(torch, dev)
    vit_launches = vit_phase(torch, dev, card)
    check_vit_dense_route(torch, dev)
    torch.cuda.empty_cache()
    check_vit_against_cpu(torch, dev)
    for name, n in launches.items():
        if name not in bn_rows:
            continue
        row = bn_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deep_vision_tpu_torch/csrc/bn_act.cu",
            "replaces": row["replaces"], "launches": n,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    for name, n in vit_launches.items():
        if name in flash_rows:
            kernels.append({"name": name, "route": "cuda",
                            "source": "deep_vision_tpu_torch/csrc/"
                                      "flash_attention.cu",
                            "launches": n, **flash_rows[name]})
    for name in ("bn_moments_fwd", "bn_moments_bwd", "layer_norm_fwd",
                 "layer_norm_bwd"):
        n = (launches if name.startswith("bn_") else vit_launches)[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "deep_vision_tpu_torch/csrc/norm.cu",
                        "launches": n, **norm_rows[name]})

    # -- 6. report -----------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
