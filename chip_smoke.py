#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py          # from the repository root; one card

Phases (any failure exits non-zero; nothing is caught and logged away):

1. setup   the card's name and power limit, torch/CUDA versions, TF32 off
           (the JAX YOLOv3 is a float32 model);
2. build   every kernel under deep_vision_tpu_torch/csrc with nvcc;
3. kernels each kernel against its plain PyTorch version on the card:
           NMS, exact equality, over the cases of kernel_cases(); bn_act
           at every (shape, residual) the flagship training step gives
           it, in f32 and bf16, channels_last and NCHW, ReLU and none,
           plus an odd C: forward, dx and dres exactly equal, dscale and
           dbias within BN_SUM_TOL of the sum of |terms| per channel;
           kernel, plain and bound times, summed over one step's calls,
           and each wrapper's host cost per call;
4. serve   YOLOv3 at 416x416, 80 classes, seeded weights, through the
           port's Engine (buckets 1, 2, 4, 8) and Server: a mixed burst
           stream, response checks, the NMS launch count against the
           batch count, one batch against the same predictor with the
           plain NMS, per-bucket latency, SLO quantiles, drain ledger;
5. train   the flagship step (ResNet-50, s2d stem, bf16, batch 128,
           SGD) through the port's Trainer: warm-up and timed steps,
           48 + 48 bn_act launches per step, a finite and falling loss;
           then one float32 step at batch 8 on the card (kernels)
           against the same step on the CPU (plain versions);
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


def detections(seed, b, n):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2).astype(np.float32) * 0.8
    wh = rng.rand(b, n, 2).astype(np.float32) * 0.25 + 0.02
    return np.concatenate([xy, xy + wh], -1), rng.rand(b, n).astype(np.float32)


def kernel_cases():
    """(label, boxes, scores, score_threshold) for phase 3."""
    cases = []
    for b in (1, 8):
        for thr in (0.3, 0.5):
            boxes, scores = detections(b, b, 10_647)
            cases.append((f"B={b} N=10647 thr={thr}", boxes, scores, thr))
    boxes, scores = detections(3, 1, 10_647)
    scores[0, [17, 4000, 9000]] = 2.0  # the tie rule: first index wins
    boxes[0, 4000] = boxes[0, 17]
    cases.append(("ties on the top score", boxes, scores, 0.5))
    boxes, scores = detections(4, 1, 10_647)
    cases.append(("all scores below threshold", boxes, scores * 0.2, 0.5))
    boxes, scores = detections(5, 2, 1_001)
    cases.append(("N=1001 (not a multiple of 32)", boxes, scores, 0.3))
    boxes, scores = detections(6, 2, 70_000)
    cases.append(("N=70000 (live scores in global memory)", boxes, scores,
                  0.5))
    return cases

def bn_act_calls(torch, model, images):
    """{(NCHW shape, has residual): calls} of the bn_act calls one
    forward of `model` makes, read by hooks on its BatchNorms in an eval
    pass without gradients: the training step's shapes, and no running
    statistic changes."""
    from deep_vision_tpu_torch.nn.layers import BatchNorm

    calls = {}

    def hook(mod, args, kwargs):
        res = kwargs.get("residual") is not None
        if mod.act is not None or res:
            key = (tuple(args[0].shape), res)
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
    return calls


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
    def bound(row):
        bytes_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = row["ops"] / FP32_FLOPS * 1e3
        return (max(bytes_ms, ops_ms),
                "bytes" if bytes_ms >= ops_ms else "operations")

    rows = {}
    for name, replaces in (("bn_act_fwd", ":78 and :89"),
                           ("bn_act_bwd", ":158")):
        for res in (False, True):
            part = parts[name, res]
            print(f"[kernels] {name} residual={res}: {part['calls']} calls "
                  f"a step, kernel {part['ms']:.4f} ms, plain "
                  f"{part['plain_ms']:.4f} ms, bound "
                  f"{bound(part)[0]:.4f} ms ({card})")
        total = {k: sum(parts[name, res][k] for res in (False, True))
                 for k in ("calls", "ms", "plain_ms", "host_ms", "bytes",
                           "ops")}
        bound_ms, bound_by = bound(total)
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


def train_phase(torch, trainer, batch, card):
    """Phase 5: the flagship step through the Trainer. Returns the
    bn_act launch counts of its run."""
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act

    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fused_scale_bias_act.launches = 0  # the training path's run starts here
    fused_scale_bias_act.backward_launches = 0
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
                "bn_act_bwd": fused_scale_bias_act.backward_launches}
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
          f"launches {launches} over {steps} steps")
    check(launches == {"bn_act_fwd": 48 * steps, "bn_act_bwd": 48 * steps},
          f"bn_act launches {launches}, want 48 + 48 per step")
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
    from deep_vision_tpu_torch.tools.profile_train import make_train_parts

    runs = {}
    for where in (dev, torch.device("cpu")):
        before_fwd = fused_scale_bias_act.launches
        trainer, batch = make_train_parts(CHECK_BATCH, "s2d", device=where,
                                          dtype=torch.float32)
        sd = trainer.model.state_dict()
        before = {k: v.detach().cpu().clone() for k, v in sd.items()}
        metrics = trainer.train_step(batch)
        after = {k: v.detach().cpu() for k, v in sd.items()}
        runs[where.type] = (float(metrics["loss"]),
                            float(metrics["grad_norm"]), before, after,
                            fused_scale_bias_act.launches - before_fwd,
                            {n for n, _ in trainer.model.named_parameters()})
        del trainer, batch
    (lk, gk, bk, ak, nk, params), (lp, gp, bp, ap, np_, _) = (
        runs["cuda"], runs["cpu"])
    check(nk > 0 and np_ == 0, f"kernel launches card {nk}, cpu {np_}")
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
    from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms, nms_plain
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
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "bytes" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- 3. kernels against plain versions -----------------------------------
    for label, boxes, scores, thr in kernel_cases():
        b = torch.from_numpy(boxes).to(dev)
        s = torch.from_numpy(scores).to(dev)
        got = greedy_nms(b, s, MAX_DET, IOU_THR, thr)
        torch.cuda.synchronize()
        want = nms_plain(b, s, MAX_DET, IOU_THR, thr)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        kept = int((got[1] >= 0).sum())
        print(f"[kernels] nms {label}: {'equal' if same else 'DIFFERENT'} "
              f"({kept} picks)")
        check(same, f"nms kernel differs from its plain version: {label}")
        if label.startswith("ties"):
            check(got[1][0, :2].tolist() == [17, 9000],
                  f"tie rule: picks {got[1][0, :3].tolist()}")
        if label.startswith("all scores"):
            check(kept == 0, "an all-below-threshold image kept a box")

    trainer, train_batch = make_train_parts(TRAIN_BATCH, "s2d", device=dev)
    calls = bn_act_calls(torch, trainer.model, train_batch["image"])
    check(sum(calls.values()) == 48,
          f"the flagship step should make 48 bn_act calls, got {calls}")
    bn_rows = bn_act_cases(torch, dev, calls, card)
    torch.cuda.empty_cache()

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
    t0 = time.perf_counter()
    rows = []
    for burst in BURSTS:
        futs = [server.submit("yolov3", requests[i]) for i in range(burst)]
        rows += [f.result(timeout=300) for f in futs]
    stream_s = time.perf_counter() - t0
    launches = greedy_nms.launches  # ... and ends here
    check(fused_scale_bias_act.launches == 0, "YOLOv3 serving ran bn_act")
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
    plain_ms, plain_us = time_cuda(torch, lambda: nms_plain(
        shifted, best, MAX_DET, IOU_THR, SCORE_THR))
    nms_ms, nms_us = time_cuda(torch, lambda: greedy_nms(
        shifted, best, MAX_DET, IOU_THR, SCORE_THR))
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
          f"rounds); library: none (no single PyTorch call computes greedy "
          f"NMS, and torchvision is not installed) ({card})")
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
    for name, n in launches.items():
        row = bn_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deep_vision_tpu_torch/csrc/bn_act.cu",
            "replaces": row["replaces"], "launches": n,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})

    # -- 6. report -----------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
