"""Time the BatchNorm moments kernels a call at a time, at every shape of
the YOLOv3 training step (float32, batch 16, 416x416) and of the
ResNet-50 s2d step (bf16, batch 128), on one CUDA card.

    python deep_vision_tpu_torch/tools/time_moments.py [--root DIR]
        [--l2 write|read|none]

`--root` is the checkout whose `deep_vision_tpu_torch` is timed (default:
this one), so two commits can be timed on one card in turn, each in
its own process, alternated. For each shape: the forward, the backward,
`torch.batch_norm_stats` and `torch.addcmul` (the backward's function,
its coefficients precomputed), device ms between CUDA events (median of
25 calls, a spin kernel holding the device while the host queues them,
as chip_smoke.py's time_cuda), and the host µs a call of the two
wrappers; then the sums over each step's calls and their bounds (bytes
at 3.35 TB/s). Before each timed call the L2 cache gets `--l2`: a 100 MB
write (time_cuda's, which leaves ~50 MB of dirty lines behind), a 100 MB
read, or nothing. It also times an empty kernel (a one-float fill_), the
floor of a reading. The last line is a JSON object of the sums.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: (rows, C) and calls a step of the YOLOv3 and ResNet-50 steps' batch
#: moments (tests/test_torch_norm_plan.py reads both off the port's models)
YOLOV3 = [((2704, 256), 1), ((2704, 512), 7), ((2704, 1024), 8),
          ((10816, 128), 1), ((10816, 256), 11), ((10816, 512), 12),
          ((43264, 128), 11), ((43264, 256), 12), ((173056, 64), 2),
          ((173056, 128), 3), ((692224, 32), 1), ((692224, 64), 2),
          ((2768896, 32), 1)]
RESNET50 = [((6272, 512), 5), ((6272, 2048), 4), ((25088, 256), 11),
            ((25088, 512), 1), ((25088, 1024), 7), ((100352, 128), 7),
            ((100352, 256), 1), ((100352, 512), 5), ((401408, 64), 6),
            ((401408, 128), 1), ((401408, 256), 4), ((1605632, 64), 1)]
RUNS, WARMUP = 25, 3
FLUSH_BYTES = 100 * 2**20
SPIN_CYCLES = 50_000_000
HBM_BYTES_PER_S = 3.35e12


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    parser.add_argument("--l2", choices=("write", "read", "none"),
                        default="write")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from deep_vision_tpu_torch.ops.cuda import build, norm

    if not torch.cuda.is_available():
        sys.exit("time_moments: no CUDA card")
    build.build(["norm"])
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    flush_buf = torch.zeros(FLUSH_BYTES // 4, device=dev)
    flush = {"write": flush_buf.zero_, "read": flush_buf.sum,
             "none": lambda: None}[args.l2]

    def timed(fn):
        """(device ms, host us): medians over RUNS calls of fn()."""
        for _ in range(WARMUP):
            fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(RUNS)]
        host = []
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        for start, end in pairs:
            flush()
            start.record()
            t = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t) * 1e6)
            end.record()
        torch.cuda.synchronize()
        return (statistics.median(s.elapsed_time(e) for s, e in pairs),
                statistics.median(host))

    # a second of work first, so that the clocks are up
    busy = torch.ones(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        busy.mul_(1.0)
    del busy
    tiny = torch.zeros(1, device=dev)
    floor_ms = timed(lambda: tiny.fill_(1.0))[0]
    print(f"root {os.path.abspath(args.root)}, L2 before each call: "
          f"{args.l2}; an empty kernel reads {floor_ms * 1e3:.2f} us "
          f"({card})")
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {"floor_us": floor_ms * 1e3, "l2": args.l2}
    for step, shapes, dtype in (("yolov3", YOLOV3, torch.float32),
                                ("resnet50", RESNET50, torch.bfloat16)):
        tot = dict.fromkeys(("fwd", "bwd", "batch_norm_stats", "addcmul",
                             "bound_fwd", "bound_bwd", "host_fwd_us",
                             "host_bwd_us"), 0.0)
        for (rows, c), n in shapes:
            x = torch.randn(rows, c, generator=gen, device=dev).to(dtype)
            u, w = (torch.randn(c, generator=gen, device=dev)
                    for _ in range(2))
            coef = norm.bn_moments_bwd_coefficients(rows, u, w)
            if not torch.equal(norm.bn_moments_backward(x, u, w),
                               norm.bn_moments_bwd_plain(x, *coef)):
                sys.exit(f"time_moments: the backward differs at {rows}x{c}")
            alpha, beta = (t.view(1, -1) for t in coef)
            (fwd, hf), (bwd, hb), (bns, _), (acm, _) = (timed(fn) for fn in (
                lambda: norm.bn_moments_forward(x),
                lambda: norm.bn_moments_backward(x, u, w),
                lambda: torch.batch_norm_stats(x, 1e-5),
                lambda: torch.addcmul(alpha, beta, x,
                                      out=torch.empty_like(x))))
            size = x.numel() * x.element_size()
            bf = (size + 8 * c) / HBM_BYTES_PER_S * 1e3
            bb = (2 * size + 8 * c) / HBM_BYTES_PER_S * 1e3
            for k, v in (("fwd", fwd), ("bwd", bwd), ("batch_norm_stats", bns),
                         ("addcmul", acm), ("bound_fwd", bf),
                         ("bound_bwd", bb)):
                tot[k] += n * v
            tot["host_fwd_us"] += n * hf
            tot["host_bwd_us"] += n * hb
            print(f"{step} {rows}x{c} x{n}: fwd {fwd * 1e3:.1f} us (host "
                  f"{hf:.1f}), bwd {bwd * 1e3:.1f} us (host {hb:.1f}), "
                  f"batch_norm_stats {bns * 1e3:.1f}, addcmul "
                  f"{acm * 1e3:.1f}; bounds {bf * 1e3:.1f} / "
                  f"{bb * 1e3:.1f} us", flush=True)
            del x
        calls = sum(n for _, n in shapes)
        tot["host_fwd_us"] /= calls
        tot["host_bwd_us"] /= calls
        sums[step] = {k: round(v, 4) for k, v in tot.items()}
        print(f"{step}, {calls} calls a step: fwd {tot['fwd']:.4f} ms "
              f"(bound {tot['bound_fwd']:.4f}), bwd {tot['bwd']:.4f} ms "
              f"(bound {tot['bound_bwd']:.4f}), batch_norm_stats "
              f"{tot['batch_norm_stats']:.4f}, addcmul {tot['addcmul']:.4f};"
              f" host {tot['host_fwd_us']:.1f} / {tot['host_bwd_us']:.1f} us"
              f" a call ({card})", flush=True)
    print(json.dumps(sums))


if __name__ == "__main__":
    main()
