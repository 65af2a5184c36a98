"""Where a YOLOv3 serving batch spends its time on the card.

    python -m deep_vision_tpu_torch.tools.profile_serve

Builds YOLOv3 as chip_smoke.py serves it (416x416, 80 classes, seeded
weights with calibrated BatchNorm statistics, TF32 off, buckets 1, 2, 4,
8), then for buckets 1 and 8 times `Engine.run` without the profiler,
and profiles the same calls with torch.profiler. Per bucket it prints
the wall time per batch, the device-busy time per batch (the sum of
kernel and copy times, which do not overlap on one stream), the busy
share of the unprofiled wall time, kernel time by group (convolution,
the NMS kernels, everything else), the NMS kernels' times by kernel
(nms_compact, nms_select) and the top kernels by name. Needs one CUDA card.
"""
from __future__ import annotations

import re
import statistics
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep_vision_tpu_torch.inference import yolo_predict_fn
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.nn.layers import calibrate_batch_stats
from deep_vision_tpu_torch.serve import Engine

IMAGE, NUM_CLASSES, RUNS = 416, 80, 5
NMS_KERNEL = re.compile(r"(?<![A-Za-z])(nms_[a-z0-9_]+)")
CONV_MARKERS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "winograd",
                "implicit", "sm90")


def nms_phase(name: str) -> Optional[str]:
    """The NMS kernel a profiler name names (nms_compact, nms_select), or
    None."""
    m = NMS_KERNEL.search(name)
    return m.group(1) if m else None


def group(name: str) -> str:
    """"nms" for the NMS kernels, tested before the convolution markers,
    which their names could otherwise match; then "conv", else "other"."""
    if nms_phase(name):
        return "nms"
    low = name.lower()
    if any(m in low for m in CONV_MARKERS):
        return "conv"
    return "other"


def device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    model = get_model("yolov3", num_classes=NUM_CLASSES, seed=0)
    dev = next(model.parameters()).device
    calibrate_batch_stats(model, torch.from_numpy(
        rng.rand(8, IMAGE, IMAGE, 3).astype(np.float32)).to(dev))
    engine = Engine()
    engine.register("yolov3", yolo_predict_fn(model, max_detections=100,
                                              iou_threshold=0.5,
                                              score_threshold=0.5),
                    model.state_dict(), input_shape=(IMAGE, IMAGE, 3))
    engine.warmup()
    card = torch.cuda.get_device_name(0)
    for bucket in (1, 8):
        x = torch.from_numpy(rng.rand(bucket, IMAGE, IMAGE, 3)
                             .astype(np.float32)).to(dev)
        walls = []
        for _ in range(RUNS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run("yolov3", x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(walls[2:])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(RUNS):
                engine.run("yolov3", x)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        by_group = {"conv": 0.0, "nms": 0.0, "other": 0.0}
        for e in kernels:
            by_group[group(e.key)] += device_us(e) / 1e3 / RUNS
        busy_ms = sum(by_group.values())
        nms_phases = {nms_phase(e.key): device_us(e) / 1e3 / RUNS
                      for e in kernels if nms_phase(e.key)}
        top = sorted(kernels, key=device_us, reverse=True)[:10]
        row = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "kernel_ms_by_group": by_group,
            "kernels_per_batch": sum(e.count for e in kernels) / RUNS,
            "top": [{"name": e.key[:90], "ms": device_us(e) / 1e3 / RUNS,
                     "calls": e.count / RUNS} for e in top],
        }
        print(f"[profile] bucket {bucket}: wall {wall_ms:.3f} ms/batch, "
              f"device busy {busy_ms:.3f} ms/batch "
              f"({100 * row['busy_share']:.1f}%), "
              f"{row['kernels_per_batch']:.0f} kernels/batch, by group "
              f"{ {k: round(v, 3) for k, v in by_group.items()} } ({card})")
        print(f"[profile]   nms by kernel, ms/batch: "
              f"{ {k: round(v, 4) for k, v in nms_phases.items()} }")
        for t in row["top"]:
            print(f"[profile]   {t['ms']:8.3f} ms  x{t['calls']:.0f}  "
                  f"{t['name']}")


if __name__ == "__main__":
    main()
