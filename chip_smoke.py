#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py          # from the repository root; one card

Phases (any failure exits non-zero; nothing is caught and logged away):

1. setup   the card's name and power limit, torch/CUDA versions, TF32 off
           (the JAX YOLOv3 is a float32 model);
2. build   every kernel under deep_vision_tpu_torch/csrc with nvcc;
3. kernels each kernel against its plain PyTorch version on the card,
           exact equality, over the cases of kernel_cases();
4. serve   YOLOv3 at 416x416, 80 classes, seeded weights, through the
           port's Engine (buckets 1, 2, 4, 8) and Server: a mixed burst
           stream, response checks, the NMS launch count against the
           batch count, one batch against the same predictor with the
           plain NMS, per-bucket latency, SLO quantiles, drain ledger;
5. report  the card line, the kernels line, and the final status line.
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

IMAGE = 416
NUM_CLASSES = 80
BUCKETS = (1, 2, 4, 8)
MAX_DET = 100
IOU_THR = 0.5
SCORE_THR = 0.5
BURSTS = (1, 3, 2, 8, 5, 4, 7, 6, 8, 1)
TIMED_RUNS = 25


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_cuda(torch, fn, runs=TIMED_RUNS, warmup=3):
    """Median milliseconds of `fn()` over `runs` launches, each between
    its own pair of CUDA events, after `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms, nms_plain
    from deep_vision_tpu_torch.serve import Engine, Server

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
    greedy_nms.launches = 0  # the main path's run starts here
    t0 = time.perf_counter()
    rows = []
    for burst in BURSTS:
        futs = [server.submit("yolov3", requests[i]) for i in range(burst)]
        rows += [f.result(timeout=300) for f in futs]
    stream_s = time.perf_counter() - t0
    launches = greedy_nms.launches  # ... and ends here
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
    plain_ms = time_cuda(torch, lambda: nms_plain(
        shifted, best, MAX_DET, IOU_THR, SCORE_THR))
    nms_ms = time_cuda(torch, lambda: greedy_nms(
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

    # -- 5. report -----------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
