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
           scaled_dot_product_attention times at the step's shape; the
           BatchNorm moments at every shape of the flagship step (bf16),
           a few in f32 and edge cases: the forward bit for bit the
           order model's (moments_order_model) and within NORM_SUM_TOL
           of the plain version, the backward bit for bit the plain
           version's, both repeating; the kernels a call from a profiler
           trace at each of these shapes and at YOLOv3's 13 step shapes
           in float32 (the forward one kernel where one cluster covers
           each column chunk, then the combine where it does not; the
           backward one); kernel, plain, bound and library times and
           host us a call; LayerNorm at the ViT shapes;
4. serve   YOLOv3 at 416x416, 80 classes, seeded weights, through the
           port's Engine (buckets 1, 2, 4, 8) and Server: a mixed burst
           stream, response checks, the NMS launch count against the
           batch count, one batch against the same predictor with the
           plain NMS, per-bucket latency, SLO quantiles, drain ledger;
           the Server runs under its black box (a journal, an installed
           Tracer and FlightRecorder, the lock sanitizer armed by
           DVT_LOCKSMITH=1): the stream's serve_batch rows, serve/batch
           spans and NMS launches equal in count, a trace id a request,
           no lock-order violation, no bundle after the clean close;
           then a second short Server drained on SIGTERM leaves one
           `preempt` bundle that validate_bundle accepts (its bytes, and
           a manual dump's bytes and ms);
           then NMS at the served batch's inputs: M per image, passes,
           one call under CUDA's sync debug mode (a host sync raises),
           kernel and plain times at B = 8 and the kernel's at B = 1;
5. train   the flagship step (ResNet-50, s2d stem, bf16, batch 128,
           SGD) through the port's Trainer: warm-up and timed steps,
           48 + 48 bn_act and 53 + 53 moments launches per step, a finite
           and falling loss; the step as fit runs it
           (`_single_step_and_log`: the step, its train/step span, the
           host read of its metrics) timed with a Tracer installed and
           without, alternated (TRACED_STEPS);
           then one float32 step at batch 8 on the card (kernels)
           against the same step on the CPU (plain versions); then
           ViT-S/16 at 512x512 (bf16, batch 64, AdamW + warmup-cosine)
           through the Trainer: 12 + 12 + 12 flash and 25 + 25 LayerNorm
           launches a step, a finite and falling loss; a 224x224
           vit_s16 forward that
           launches no flash kernel (the dense route); and one float32
           batch-2 ViT step on the card against the CPU: loss, grad norm
           and every parameter's gradient within VIT_CHECK_TOL;
5b. feed   the flagship step fed from records (after the ResNet steps of
           phase 5): FEED_IMAGES seeded 256x256 images written as raw
           pixels in FEED_SHARDS shards by the port's RecordWriter (and
           as JPEG records in the ImageNet schema where cv2 or PIL
           imports, whose chain adds the Rescale), read through a
           RecordDataset, the reference's ImageNet train chain and a
           DataLoader of batch 128; the host chain's images/s with 8 and
           16 thread workers, and for JPEG records also 4 worker
           processes (feed_modes); then
           Trainer(device_prefetch=2).fit over the loader: a checked
           epoch (48 + 48 bn_act and 53 + 53 moments launches a step, a
           finite loss, a step for every batch, and each batch as the
           step consumed it on the card bitwise equal to the host batch
           the loader yielded, by checksums, while the copy stream is
           held back before each copy longer than a batch waits in the
           prefetch queue, and the compute stream kept busy before each
           read), then a timed epoch in each of those worker modes:
           ms/step against phase 5's fixed batch, the host's time in
           train_step, the feed's starvation counters, host ms a
           _place_one, pinned-block reuse; and the copy stream's time
           for one (128, 112, 112, 12) float32 batch;
6. cli     the training CLI as a user runs it, in subprocesses:
           `python -m deep_vision_tpu_torch.train_cli -m resnet50` (float32,
           batch 256, s2d stem) on CLI_TRAIN_IMAGES seeded 256x256 JPEG
           records in tfrecord_train/ and CLI_VAL_IMAGES in
           tfrecord_val/, with --data-snapshot, a journal and the
           skip_step policy: run T trains 2 epochs (ms/step, images/s,
           peak memory, save and restore times, LR and val top1 by
           epoch, from its journal); under DVT_DETERMINISTIC=1, run A
           trains 2 epochs and run B 1 epoch, then `-c` to 2 in a fresh
           process: B's second epoch must read A's batches (checksums
           from a sitecustomize hook) and its final checkpoint must equal
           A's bitwise; run S, with --trace and --flight-dir, gets
           SIGTERM mid-epoch and must exit 75 (the requeue code) after a
           preempt save, with a trace of one train/step span a step and
           one valid `preempt` bundle, and its `-c` resume must finish
           every step; then
           in this process the CLI's route (build_dataloaders,
           build_trainer) on the first batch: its step loss against run
           A's first step, every float32 bn_act and moments call of the
           step against its plain version with times and bounds, and the
           step timed with the skip_step policy off and on;
7. zoo     the rest of the classifier zoo (ZOO_BN: lenet5,
           alexnet1/2, vgg16/19, inception1/3, resnet50v2, mobilenet1,
           shufflenet1), each as registered (width, input, batch,
           float32, its optimizer and schedule) through the CLI's
           `build_trainer` on the CLI's seeded fake batch: warm-up and
           timed steps (ms/step, images/s, peak memory), the bn_act and
           moments launches a step against ZOO_BN's counts, a finite
           loss; mobilenet1's and shufflenet1's every bn_act and moments
           call of a step against its plain version with times and
           bounds; each model's float32 step at a small batch on the card
           against the CPU, the CPU taking the card's ReLU and max-pool
           decisions (ZOO_CHECK_TOL); then in subprocesses `train_cli -m
           mobilenet1` on phase 6's records under DVT_DETERMINISTIC=1, 2
           epochs straight and 1 + `-c auto`, ending bitwise equal, and
           `train_cli -m lenet5` one epoch on seeded MNIST idx files;
8. vmoe    vmoe_s16 as registered (float32, batch 256, 224, AdamW with
           warmup and cosine) through the CLI's `build_trainer` on the
           CLI's seeded fake batch: warm-up and timed steps (ms/step,
           images/s, peak memory, moe_aux, router entropy and the
           largest expert share), 25 + 25 LayerNorm launches a step and
           no flash or moments launch (T = 196 takes the dense
           attention); the LayerNorm kernels at its float32 (256, 196,
           384) shape against their plain versions with times, bounds
           and F.layer_norm's; one float32 step at batch 2 on the card
           against the CPU, the card taking the CPU's expert choice
           where the top two gates lie within GATE_MARGIN;
9. det     `train_cli -m yolov3_coco` as registered (416, batch 16,
           Adam and plateau on the loss) for DET_EPOCHS epochs on seeded
           COCO-layout images that `tools/convert.py coco` turned into
           records: ms/step from its journal, peak memory, 72 + 72
           moments launches a step; `--eval-only` from its checkpoint,
           printing mAP@.5 and mAP@[.5:.95] with one NMS launch a val
           batch; in this process every moments call of its step at the
           registered batch against the order model and the plain
           version, with each shape's time and host us a call, bound and
           library times; NMS at
           --eval-only's inputs (score 0.1) against its plain version
           with times and bound; one float32 step at batch 2 on the card
           against the CPU, the CPU taking the card's leaky-ReLU and
           ignore-mask decisions (DET_CHECK_TOL);
10. gan_pose the last four configs, each as registered (width, input,
           batch, float32, optimizer) through the CLI's `build_trainer`
           (hourglass_mpii, centernet_coco) or `build_gan_trainer`
           (dcgan_mnist; cyclegan with one A and one B image, the
           reference's feed) on the CLI's seeded fake batch:
           GAN_POSE_WARMUP then GAN_POSE_STEPS timed steps (ms/step,
           images/s, peak memory, finite losses, both for the GANs), the
           moments' launches a step against GAN_POSE_BN; every
           moments call of a Hourglass, CenterNet and DCGAN step against
           the order model and the plain version, with kernel, plain,
           bound and library times summed over a step and host us a
           call (DCGAN's (256, 12544) through the 2-D route), and the
           kernels a call at each shape from a child process's trace;
           a float32 step of each on the card against the CPU
           (GAN_POSE_CHECK_TOL: Hourglass and CenterNet at their
           registered inputs, batch 1, the card's ReLU and max-pool
           decisions replayed; DCGAN with the noise and dropout masks
           passed in; CycleGAN at 64x64, G step, pool and D step, the
           gradients read where the trainer applies them); then in
           subprocesses `train_cli -m hourglass_mpii` 2 epochs on
           seeded MPII people through `tools/convert.py mpii` and its
           `--eval-only` (PCK), `-m centernet_coco` one epoch on seeded
           512x512 COCO-layout records and its `--eval-only` (mAP),
           `-m cyclegan --batch-size 2` 2 epochs on image folders
           through `tools/convert.py cyclegan` and a `-c` resume to a
           third, `-m dcgan_mnist --fake-data` one epoch and a resume to
           a second, each run's moments launches counted by the hook;
           the kernels line gains `bn_moments_*[hourglass_mpii]`,
           `[centernet_coco]` and `[dcgan_mnist]`;
11. infer  the inference CLI, `deep_vision_tpu_torch.tools.infer.main`
           in this process, INFER_CALLS times for each family on
           INFER_IMAGES seeded JPEGs: resnet50 with -c on run T's
           checkpoint of phase 6, vit_s16 and the GANs from the seeded
           init, yolov3_voc with -c on the seeded weights with running
           statistics calibrated on the JPEGs and its heads set to
           overlapping boxes (YOLO_HEAD_WH), hourglass_mpii and
           centernet_coco with -c on phase 10's checkpoints; each call's
           NMS, bn_act and LayerNorm launches against INFER_LAUNCHES
           (48 bn_act for resnet50, 25 LayerNorm for vit_s16, one NMS
           for yolov3_voc, no flash, moments or backward), the results
           and files each family writes, the same printed results on
           every call, and the first call's and the steady state's wall
           time per image; resnet50 and yolov3_voc once more on the
           card and with `--device cpu`, their model outputs caught by
           a forward hook and held against each other within
           INFER_RTOL, and yolov3_voc's detections within
           INFER_DET_TOL; then the path's bn_act forward calls
           (resnet50's eval forward) and its LayerNorm shape against
           their plain versions with times and bounds, and NMS at
           yolov3_voc's inputs at score 0.3; the kernels line gains
           `bn_act_fwd[infer -m resnet50]`, `layer_norm_fwd[infer -m
           vit_s16]` and `nms[infer -m yolov3_voc]`;
12. report the card line, the kernels line, and the final status line.
"""
import contextlib
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
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
#: phase 5: the flagship step through Trainer._single_step_and_log, as
#: fit runs it, with a Tracer installed and without: runs alternated
#: untraced, traced, traced, untraced, TRACED_STEPS steps each, the
#: first TRACED_WARMUP of each run left out of its median
TRACED_STEPS, TRACED_WARMUP = 12, 2
CHECK_BATCH = 8
#: the float32 batch-8 step, card (kernels) against CPU (plain versions):
#: loss and grad norm relative; each parameter's update and each running
#: statistic relative to the largest magnitude of its tensor. cuDNN and
#: the CPU's convolutions sum in other orders, and a ReLU input or a
#: max-pool pair within an ulp of a tie can fall the other way, sending
#: one element's gradient elsewhere (tests/test_torch_train.py)
CHECK_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "update": 2e-2, "stats": 1e-3}
#: phase 5b: one epoch of the fed step, 8 batches of 128
FEED_IMAGES, FEED_SHARDS, FEED_SIZE = 1024, 8, 256
FEED_DEPTH = 2
#: the feed's worker modes, measured alone and in the fed step: all three
#: for JPEG records, the thread modes for raw ones (each worker-process
#: mode costs ~12 s of spawning a reading, and the decode-free raw
#: records are not what a process pool is for). One process mode: the
#: 8-process one took ~40 s of a run near its 1,200 s limit (PERF.md
#: keeps its last readings)
HOST_CHAIN_MODES = ({"num_workers": 8, "num_procs": 0},
                    {"num_workers": 16, "num_procs": 0},
                    {"num_procs": 4})


def feed_modes(encoding):
    """HOST_CHAIN_MODES for `encoding`'s records."""
    return tuple(m for m in HOST_CHAIN_MODES
                 if encoding == "jpeg" or not m.get("num_procs"))
#: the checked epoch's spins at the H100's clocks: ~1 s on the copy
#: stream before each copy, longer than a batch waits in the prefetch
#: queue (two steps of ~250 ms), so a step that did not wait for its copy
#: would read the batch before it lands; ~10 ms on the compute stream
#: before each read
COPY_HOLD_CYCLES, READ_HOLD_CYCLES = 2_000_000_000, 20_000_000


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


def nms_bound(torch, best, indices, thr):
    """The least time greedy NMS could take on these inputs: each box and
    score read once and the picks written once, against
    NMS_OPS_PER_CANDIDATE operations over each image's candidates (its
    M_i boxes at a score >= thr and > 0; greedy NMS never looks at the
    others) in each round this run's data needs (a round a pick, and one
    more that finds none where an image keeps fewer than MAX_DET; none
    where M_i = 0). best: (B, N) scores; indices: the kernel's
    (B, MAX_DET) picks. -> (bound ms, bound by, bytes, operations,
    rounds, picks per image)."""
    nb, n = best.shape
    picks = (indices >= 0).sum(dim=1)
    m = ((best >= thr) & (best > 0.0)).sum(dim=1)
    rounds = torch.clamp(picks + (picks < MAX_DET).long(), max=MAX_DET)
    rounds = torch.where(m > 0, rounds, torch.zeros_like(rounds))
    nbytes = nb * n * (16 + 4) + nb * MAX_DET * (4 + 4)
    ops = NMS_OPS_PER_CANDIDATE * int((m * rounds).sum())
    return (*bound_of(nbytes, ops), nbytes, ops, int(rounds.sum()), picks)


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


def moments_kernels_child(spec):
    """Run in a child process by check_moments_launches: for each
    [shape, dtype name] of the JSON `spec`, one forward and one backward
    call of the moments wrappers on a seeded input, under torch.profiler,
    each call framed by a spin kernel (torch.cuda._sleep) on the stream;
    prints, as its last line, the names of the device kernels of each
    call, split at the spin kernels, from the raw trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deep_vision_tpu_torch.ops.cuda.norm import (
        bn_moments_backward,
        bn_moments_forward,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    fns = []
    for shape, dtype in json.loads(spec):
        x = norm_input(torch, dev, tuple(shape), getattr(torch, dtype),
                       "normal", gen)
        u, w = (torch.randn(shape[1], generator=gen, device=dev)
                for _ in range(2))
        bn_moments_forward(x), bn_moments_backward(x, u, w)  # built, loaded
        fns += [lambda x=x: bn_moments_forward(x),
                lambda x=x, u=u, w=w: bn_moments_backward(x, u, w)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            torch.cuda._sleep(1)
            fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    calls = []
    for e in sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns()):
        if "spin_kernel" in e.name():
            calls.append([])
        elif calls:
            calls[-1].append(e.name())
    print(json.dumps({"calls": calls}))


def check_moments_launches(torch, cases, tag):
    """The kernels of one forward and one backward call at each of
    `cases`, (x, u, w, plan, label), read from a profiler trace taken in a
    child process (moments_kernels_child): a profiler session leaves
    CUPTI attached to its process, which would slow every later phase's
    host. The forward is bn_moments_fwd alone where its plan has one
    cluster a chunk, and bn_moments_combine after it where it has
    several; the backward is bn_moments_bwd alone."""
    spec = json.dumps([[list(x.shape), str(x.dtype).split(".")[-1]]
                       for x, *_ in cases])
    out = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.moments_kernels_child(sys.argv[1])", spec],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"{tag} the moments kernels' trace failed: "
          f"{out.stderr[-3000:]}")
    calls = json.loads(out.stdout.strip().splitlines()[-1])["calls"]
    check(len(calls) == 2 * len(cases) + 1 and not calls[-1],
          f"{tag} the trace framed {len(calls) - 1} calls, want "
          f"{2 * len(cases)}")
    for i, names in enumerate(calls[:-1]):
        plan, label = cases[i // 2][3:]
        expect = (["bn_moments_bwd"] if i % 2 else
                  ["bn_moments_fwd", "bn_moments_combine"][:plan.launches])
        check(len(names) == len(expect)
              and all(e in n for e, n in zip(expect, names)),
              f"{tag} moments {'backward' if i % 2 else 'forward'} at "
              f"{label} launched {names}, want {expect}")
    one = sum(plan.launches == 1 for *_, plan, _ in cases)
    print(f"{tag} moments launches a call (profiler trace, child process): "
          f"forward 1 at {one} shapes, 2 (several clusters, then the "
          f"combine) at {len(cases) - one}; backward 1 at all {len(cases)}")


def check_moments_model(torch, x, got, label):
    """The forward's E1, E2 at x against moments_order_model on the card,
    bit for bit. Returns the plan."""
    from deep_vision_tpu_torch.ops.cuda.norm import (
        moments_order_model,
        moments_plan,
        moments_rows,
    )

    rows, c = moments_rows(x), x.shape[1]
    plan = moments_plan(rows, c, torch.cuda.get_device_properties(
        x.device).multi_processor_count, x.element_size())
    xr = x.permute(0, 2, 3, 1).reshape(rows, c) if x.dim() == 4 else x
    model = moments_order_model(xr, plan)
    check(all(torch.equal(g, m) for g, m in zip(got, model)),
          f"bn_moments forward differs from moments_order_model: {label} "
          f"{plan}")
    return plan


def yolov3_moment_shapes(torch, dev):
    """{NCHW shape: calls} of the batch moments of a YOLOv3 training step
    at DET_CONFIG's batch and IMAGE, read by batchnorm_calls off the
    port's model (seeded, float32)."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.models import get_model

    cfg = get_config(DET_CONFIG)
    model = get_model(cfg.model, num_classes=cfg.num_classes, device=dev,
                      seed=0, train=True)
    images = torch.zeros(cfg.batch_size, IMAGE, IMAGE, 3, device=dev)
    _, moments = batchnorm_calls(torch, model, images)
    check(sum(moments.values()) == DET_BN,
          f"a YOLOv3 step should take {DET_BN} batch moments: {moments}")
    return moments


def moments_cases(torch, dev, calls, card, launch_calls=None):
    """Phase 3 for the BatchNorm moments: every shape of `calls` (the
    flagship step's BatchNorms) in bf16, channels_last, and the first
    three in f32, then the edge cases. E[x] and E[x^2] within
    NORM_SUM_TOL x mean |terms| per channel of the plain version, both
    errors against a float64 sum printed; the backward bit for bit; both
    bit for bit on a second call. The main path's shapes are timed.
    The forward also bit for bit against moments_order_model, and the
    kernels a call, read from a profiler trace, at each timed shape and
    at each shape of `launch_calls` in float32 (YOLOv3's step: this
    early in the run the trace is whole; once the training CLI's loaders
    have run in this process, kineto loses device records).
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
    timed = []  # (x, u, w, plan, label) of the step's shapes
    for shape, dtype, case, n in cases:
        x = norm_input(torch, dev, shape, dtype, case, gen)
        rows, c = moments_rows(x), shape[1]
        got, again = bn_moments_forward(x), bn_moments_forward(x)
        want = bn_moments_plain(x)
        plan = check_moments_model(torch, x, got, f"{shape} {dtype} {case}")
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
        print(f"[kernels] bn_moments {shape} {dtype} {case}: forward equal "
              f"to moments_order_model ({plan}) and within "
              f"{NORM_SUM_TOL} x sum|terms| of the plain version, error "
              f"against a float64 sum as a share of sum|terms|: "
              f"{'; '.join(errs)}; backward equal; both repeat bitwise")
        if n:
            timed.append((x, u, w, plan, f"{shape} {dtype}"))
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
                  f"{times[0]:.4f} ms, host {host[0]:.1f} us a call (plain "
                  f"{times[1]:.4f}, torch.batch_norm_stats {times[2]:.4f}, "
                  f"bytes bound {bound_of(size + 8 * c, 0)[0]:.4f}), bwd "
                  f"{times[3]:.4f} ms, host {host[3]:.1f} us a call (plain "
                  f"{times[4]:.4f}, torch.addcmul {times[5]:.4f}, bytes "
                  f"bound {bound_of(2 * size + 8 * c, 0)[0]:.4f}) ({card})")
        del x, xd, got, again, want, dx
    for shape, _ in sorted((launch_calls or {}).items()):
        x = norm_input(torch, dev, shape, torch.float32, "normal", gen)
        u, w = (torch.randn(shape[1], generator=gen, device=dev)
                for _ in range(2))
        plan = check_moments_model(torch, x, bn_moments_forward(x),
                                   f"{shape} float32")
        timed.append((x, u, w, plan, f"{shape} float32"))
    # one cluster a chunk, so one launch, at ResNet-50's 7x7 and 14x14 and
    # YOLOv3's 13x13, 26x26 and 52x52
    single = [label for x, _, _, plan, label in timed if plan.clusters > 1
              and x.shape[2] <= (52 if x.dtype == torch.float32 else 14)]
    check(not single, f"the moments forward takes several clusters a "
          f"chunk at {single}")
    check_moments_launches(torch, timed, "[kernels]")
    del timed
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


def layer_norm_cases(torch, dev, card, cases=None, tag="[kernels]"):
    """Phase 3 for LayerNorm: the ViT step's shapes (64 x 1024 rows of
    384: bf16 in and out for the 24 block LayerNorms, f32 for the final
    one), then the edge cases; or `cases`, (shape, dtype, out dtype,
    input case, calls a step) each. y, mean, rstd and dx within
    ln_share's tolerance, dscale and dbias within NORM_SUM_TOL x k x sum
    |terms|, all bit for bit on a second call. The main path's shapes
    (calls a step > 0) are timed. Returns the kernels line's fields for
    layer_norm_fwd and layer_norm_bwd, times summed over one step's
    calls."""
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
    cases = cases or [
             (step, bf16, bf16, "normal", 24), (step, f32, f32, "normal", 1),
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
        print(f"{tag} layer_norm {label} (k {k:.3g}): shares of the "
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
            print(f"{tag} layer_norm {label} x{n}/step: fwd "
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
        print(f"{tag} {name} over one step's {row['calls']} calls "
              f"(replaces flax's LayerNorm, vit.py:156, :158, :225): kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / row['ms']:.1f}% of the bound; "
              f"F.layer_norm {library} {row['library_ms']:.4f} ms; host "
              f"{1e3 * row['host_ms'] / row['calls']:.1f} us a call ({card})")
    print(f"{tag} layer_norm: {len(cases)} cases within tolerance")
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
    return launches, step_ms, wall_ms


def serve_black_box(tmp):
    """Phase 4's black box for the serving run: a journal, the lock
    sanitizer armed by DVT_LOCKSMITH=1 (arm_from_env, as train_cli
    arms it), an installed Tracer and an installed FlightRecorder that
    taps the journal. -> (journal, sanitizer, tracer, recorder)."""
    from deep_vision_tpu_torch.obs import flight, locksmith, trace
    from deep_vision_tpu_torch.obs.journal import RunJournal

    journal = RunJournal(os.path.join(tmp, "serve.jsonl"), kind="serve")
    journal.manifest(config={"name": "chip_smoke_serve",
                             "task": "serving"})
    prev = os.environ.get("DVT_LOCKSMITH")
    os.environ["DVT_LOCKSMITH"] = "1"
    try:
        sanitizer = locksmith.arm_from_env(journal=journal)
    finally:  # the CLI subprocesses of later phases run disarmed
        if prev is None:
            del os.environ["DVT_LOCKSMITH"]
        else:
            os.environ["DVT_LOCKSMITH"] = prev
    check(sanitizer is not None, "DVT_LOCKSMITH=1 did not arm")
    tracer = trace.Tracer(os.path.join(tmp, "serve.trace.json"),
                          run_id=journal.run_id)
    trace.set_tracer(tracer)
    recorder = flight.FlightRecorder(os.path.join(tmp, "flight"),
                                     run_id=journal.run_id)
    recorder.attach(journal)
    flight.set_flight(recorder)
    return journal, sanitizer, tracer, recorder


def spans_of(path):
    """A trace file's complete events, parsed (fails if it is not JSON
    with a traceEvents list)."""
    with open(path) as f:
        doc = json.load(f)
    check(isinstance(doc.get("traceEvents"), list),
          f"{path} has no traceEvents list")
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def bundle_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def serve_sigterm_drain(torch, engine, journal, recorder, requests, card):
    """Phase 4: a second short Server drained on SIGTERM must leave one
    `preempt` flight bundle that the port's validate_bundle accepts.
    -> the bundle's path."""
    from deep_vision_tpu_torch.obs import flight
    from deep_vision_tpu_torch.serve import Server

    fdir = recorder.flight_dir
    check(flight.find_bundles(fdir) == [],
          f"the clean drain left bundles {flight.find_bundles(fdir)}")
    server = Server(engine, journal=journal, max_wait_ms=60_000).start()
    prev = signal.getsignal(signal.SIGTERM)
    try:
        server.install_sigterm()
        futs = [server.submit("yolov3", requests[i]) for i in range(2)]
        os.kill(os.getpid(), signal.SIGTERM)
        check(server.wait_for_stop(timeout=60), "SIGTERM did not stop the "
              "second server")
        t0 = time.perf_counter()
        summary = server.drain("sigterm")
        drain_ms = (time.perf_counter() - t0) * 1e3
        for f in futs:
            f.result(timeout=300)
    finally:
        server.uninstall_sigterm()
        signal.signal(signal.SIGTERM, prev)
    bundles = flight.find_bundles(fdir)
    check(summary["outcome"] == "flushed" and summary["completed"] == 2,
          f"the SIGTERM drain: {summary}")
    check(len(bundles) == 1 and bundles == [summary["flight_bundle"]]
          and bundles[0].endswith("-preempt"),
          f"the SIGTERM drain left bundles {bundles}")
    errors = flight.validate_bundle(bundles[0])
    check(errors == [], f"the preempt bundle is not valid: {errors}")
    t0 = time.perf_counter()
    manual = recorder.dump("manual")
    dump_ms = (time.perf_counter() - t0) * 1e3
    check(flight.validate_bundle(manual) == [], "the manual bundle")
    print(f"[serve] SIGTERM drain of a second server: {summary['completed']}"
          f" requests flushed in {drain_ms:.1f} ms (the preempt dump "
          f"included); one valid preempt bundle of "
          f"{bundle_bytes(bundles[0])} B "
          f"({sorted(os.listdir(bundles[0]))}); a manual dump of the same "
          f"rings: {bundle_bytes(manual)} B in {dump_ms:.2f} ms, host "
          f"clock ({card})")
    return bundles[0]


def serve_stream(server, requests):
    """Phase 4's request stream: the BURSTS, each submitted from this
    thread and waited for. -> (rows, seconds, median host us a submit)."""
    rows, submit_us = [], []
    t0 = time.perf_counter()
    for burst in BURSTS:
        t = time.perf_counter()
        futs = [server.submit("yolov3", requests[i]) for i in range(burst)]
        submit_us.append((time.perf_counter() - t) / burst * 1e6)
        rows += [f.result(timeout=300) for f in futs]
    return rows, time.perf_counter() - t0, statistics.median(submit_us)


def bare_stream(engine, requests, armed, card):
    """Phase 4: the same stream through a Server with no journal, tracer,
    recorder or sanitizer, in the same process after the armed one, so
    the two read what the armed black box costs the stream. `armed` is
    the armed stream's (batches, seconds, us a submit)."""
    from deep_vision_tpu_torch.serve import Server

    server = Server(engine, max_wait_ms=5.0).start()
    rows, secs, submit_us = serve_stream(server, requests)
    summary = server.close()
    batches = server.slo.report()["yolov3"]["batches"]
    check(summary["completed"] == len(rows) == sum(BURSTS),
          f"the bare stream: {summary}")
    print(f"[serve] the stream without the black box: {batches} batches, "
          f"{secs:.3f} s, {submit_us:.1f} us a submit; armed (journal, "
          f"tracer, recorder, lock sanitizer): {armed[0]} batches, "
          f"{armed[1]:.3f} s, {armed[2]:.1f} us a submit; host clock, "
          f"max_wait_ms 5 ({card})")


def serve_stream_checks(journal, sanitizer, tracer, launches, batches,
                        card):
    """Phase 4, after the stream's clean close: its serve_batch rows,
    serve/batch spans and NMS launches agree in count, each request has
    its own trace id, and the armed sanitizer has seen no lock-order
    violation."""
    from deep_vision_tpu_torch.obs.journal import read_journal

    tracer.flush()
    rows = read_journal(journal.path)
    spans = spans_of(tracer.path)
    report = sanitizer.report()
    n_rows = sum(r["event"] == "serve_batch" for r in rows)
    n_spans = sum(e["name"] == "serve/batch" for e in spans)
    requests = [r for r in rows if r["event"] == "serve_request"]
    print(f"[serve] black box: {n_rows} serve_batch rows, {n_spans} "
          f"serve/batch spans, {launches} nms launches, {batches} batches; "
          f"{len(requests)} serve_request rows with "
          f"{len({r['trace_id'] for r in requests})} trace ids; "
          f"{len(spans)} spans in {os.path.getsize(tracer.path)} B of "
          f"trace; lock sanitizer: {len(report['violations'])} violations,"
          f" {sum(v['acquisitions'] for v in report['locks'].values())} "
          f"acquisitions of {sorted(report['locks'])}, longest hold "
          f"{report['max_hold_ms']} ms ({report['max_hold_lock']}) "
          f"({card})")
    check(n_rows == n_spans == launches == batches,
          f"serve_batch rows {n_rows}, serve/batch spans {n_spans}, nms "
          f"launches {launches} and batches {batches} differ")
    check(report["violations"] == [] and not any(
        r["event"] == "lock_order_violation" for r in rows),
        f"lock-order violations: {report['violations']}")
    check(sum(e["name"] == "serve/warmup" for e in spans) == len(BUCKETS),
          "a serve/warmup span a bucket")
    check(len({r["trace_id"] for r in requests}) == len(requests),
          "each request its own trace id")


def close_serve_black_box(journal, sanitizer, tracer, recorder):
    """Phase 4: disarm the sanitizer (still no violation after the
    SIGTERM drain), close the tracer, the recorder and the journal; the
    journal has the preempt bundle's flight_dump event."""
    from deep_vision_tpu_torch.obs import flight, locksmith, trace
    from deep_vision_tpu_torch.obs.journal import read_journal

    violations = sanitizer.violations()
    locksmith.disarm()
    trace.set_tracer(None)
    tracer.close()
    recorder.close()
    journal.close()
    rows = read_journal(journal.path)
    check(violations == [] and not any(
        r["event"] == "lock_order_violation" for r in rows),
        f"lock-order violations: {violations}")
    check(any(r["event"] == "flight_dump" and r["reason"] == "preempt"
              and r["outcome"] == "written" for r in rows),
          "no flight_dump event for the preempt bundle")
    check(rows[-1]["event"] == "exit", "the serving journal has no exit")
    check(flight.get_flight() is None, "the recorder stayed installed")
    spans_of(tracer.path)


def traced_step_times(torch, trainer, batch, card, tmp):
    """Phase 5: the flagship step through `_single_step_and_log` (the
    step, its `train/step` span and the one host read of its metrics, as
    fit runs it) with a Tracer installed and without, alternated in one
    process: untraced, traced, traced, untraced. -> (untraced ms, traced
    ms), medians of the wall clock a step."""
    from deep_vision_tpu_torch.obs import trace

    times = {"untraced": [], "traced": []}
    spans = 0
    for i, mode in enumerate(("untraced", "traced", "traced", "untraced")):
        tracer = None
        if mode == "traced":
            tracer = trace.Tracer(os.path.join(tmp, f"step{i}.trace.json"))
            trace.set_tracer(tracer)
        trainer.logger.start_epoch()
        try:
            torch.cuda.synchronize()
            for k in range(TRACED_STEPS):
                t0 = time.perf_counter()
                trainer._single_step_and_log(batch, epoch=0)
                if k >= TRACED_WARMUP:
                    times[mode].append((time.perf_counter() - t0) * 1e3)
        finally:
            if tracer is not None:
                trace.set_tracer(None)
                tracer.close()
        if tracer is not None:
            steps = [e for e in spans_of(tracer.path)
                     if e["name"] == "train/step"]
            check(len(steps) == TRACED_STEPS and all(
                "step" in e["args"] for e in steps),
                f"{len(steps)} train/step spans over {TRACED_STEPS} steps")
            spans += len(steps)
            span_us = statistics.median(e["dur"] for e in steps)
            size = os.path.getsize(tracer.path)
    untraced = statistics.median(times["untraced"])
    traced = statistics.median(times["traced"])
    print(f"[train] flagship step through _single_step_and_log, wall "
          f"clock a step (host read of the metrics included), median of "
          f"{len(times['traced'])}: untraced {untraced:.3f} ms, traced "
          f"{traced:.3f} ms ({(traced / untraced - 1) * 100:+.2f}%); "
          f"{spans} train/step spans, median span {span_us:.1f} us (the "
          f"host's issue time of a step), {size} B of trace a run of "
          f"{TRACED_STEPS} steps ({card})")
    return untraced, traced


def checksum_weights(n):
    """Position weights of the placement checksums: 1..65521, cycling."""
    return np.arange(n, dtype=np.int64) % 65521 + 1


def host_checksum(a, weights):
    """(sum, weighted sum) of a host array's 32-bit words, as int64 with
    wrap-around: the same for any summation order."""
    w = a.reshape(-1).view(np.int32).astype(np.int64)
    return int(w.sum()), int((w * weights[:w.size]).sum())


def device_checksum(torch, t, weights):
    """host_checksum of a card tensor, on the current stream (no sync)."""
    w = t.reshape(-1).view(torch.int32).to(torch.int64)
    return torch.stack([w.sum(), (w * weights[:w.numel()]).sum()])


def feed_variants():
    """(variants to run, why): raw always; jpeg where cv2 or PIL imports
    (the card may have neither)."""
    have, missing = [], []
    for name in ("cv2", "PIL"):
        try:
            have.append(f"{name} {__import__(name).__version__}")
        except ImportError as e:
            missing.append(f"{name}: {e}")
    if have:
        return ("raw", "jpeg"), (f"raw always; jpeg because "
                                 f"{' and '.join(have)} imports")
    return ("raw",), f"raw always; no jpeg ({'; '.join(missing)})"


def host_chain(pattern, encoding, card):
    """The host chain alone, records -> transforms -> collate, one epoch
    in each of `feed_modes(encoding)`: images/s after the first batch."""
    from deep_vision_tpu_torch.tools.profile_train import make_record_loader

    for mode in feed_modes(encoding):
        loader = make_record_loader(pattern, encoding=encoding, **mode)
        t0 = time.perf_counter()
        first, n = None, 0
        for b in loader:
            n += len(b["image"])
            if first is None:
                first, n_first = time.perf_counter(), n
        t1 = time.perf_counter()
        check(n == FEED_IMAGES, f"the host chain gave {n} images")
        print(f"[feed] host chain ({encoding}), {mode_name(mode)}: "
              f"{(n - n_first) / (t1 - first):.1f} images/s after the first "
              f"batch ({(t1 - t0):.3f} s for {n} images, first batch "
              f"{(first - t0) * 1e3:.1f} ms) ({card})")


def fed_epochs(torch, dev, pattern, encoding, step_ms, card):
    """Trainer(device_prefetch=FEED_DEPTH).fit over the record loader: a
    checked epoch with FEED_WORKERS, then a timed epoch in each worker
    mode."""
    from deep_vision_tpu_torch.obs.registry import get_registry
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments
    from deep_vision_tpu_torch.tools.profile_train import (
        FEED_WORKERS,
        make_record_loader,
        make_train_parts,
    )

    trainer, _ = make_train_parts(TRAIN_BATCH, "s2d", device=dev,
                                  device_prefetch=FEED_DEPTH)
    loader = make_record_loader(pattern, encoding=encoding)
    steps = FEED_IMAGES // TRAIN_BATCH
    reg = get_registry()
    counters = {
        "device_prefetch_starved_total": reg.counter(
            "device_prefetch_starved_total", labels={"loader": "train"}),
        "data_prefetch_starved_total": reg.counter(
            "data_prefetch_starved_total", labels={"loader": "default"}),
        "data_batches_total": reg.counter(
            "data_batches_total", labels={"loader": "default"})}
    place = reg.histogram("device_prefetch_place_ms",
                          labels={"loader": "train"})
    print(f"[feed] checked epoch ({encoding}) with {FEED_WORKERS}")
    weights = torch.from_numpy(checksum_weights(
        TRAIN_BATCH * 112 * 112 * 12)).to(dev)
    host_weights = checksum_weights(TRAIN_BATCH * 112 * 112 * 12)

    # -- the checked epoch: the copy stream is held back before each copy,
    # so a step that did not wait for its batch's event would read it
    # before it lands; the compute stream is kept busy before each read
    kept, consumed, losses = [], [], []

    def held_back():
        for b in loader:
            kept.append({k: v.copy() for k, v in b.items()})
            with torch.cuda.stream(trainer.copy_stream):
                torch.cuda._sleep(COPY_HOLD_CYCLES)
            yield b

    def read_image(module, args):
        torch.cuda._sleep(READ_HOLD_CYCLES)
        consumed.append([device_checksum(torch, args[0], weights)])

    loss_fn = trainer.loss_fn

    def read_label(outputs, batch):
        consumed[-1].append(device_checksum(torch, batch["label"], weights))
        loss, metrics = loss_fn(outputs, batch)
        losses.append(loss.detach())
        return loss, metrics

    hook = trainer.model.register_forward_pre_hook(read_image)
    trainer.loss_fn = read_label
    torch.cuda.synchronize()
    fused_scale_bias_act.launches = 0  # the fed path's run starts here
    fused_scale_bias_act.backward_launches = 0
    batch_moments.launches = 0
    batch_moments.backward_launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(lambda: held_back())
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    launches = {"bn_act_fwd": fused_scale_bias_act.launches,
                "bn_act_bwd": fused_scale_bias_act.backward_launches,
                "bn_moments_fwd": batch_moments.launches,
                "bn_moments_bwd": batch_moments.backward_launches}
    # ... and ends here
    hook.remove()
    trainer.loss_fn = loss_fn
    losses = [float(v) for v in losses]
    print(f"[feed] checked epoch ({encoding}): {len(kept)} batches, "
          f"{trainer.state.step} steps in {checked_s:.2f} s, loss by step "
          f"{[round(v, 4) for v in losses]}, history {history}; launches "
          f"{launches}")
    check(len(kept) == steps == trainer.state.step == len(consumed),
          f"{len(kept)} batches, {trainer.state.step} steps, "
          f"{len(consumed)} consumed: want {steps} each")
    check(launches == {"bn_act_fwd": 48 * steps, "bn_act_bwd": 48 * steps,
                       "bn_moments_fwd": 53 * steps,
                       "bn_moments_bwd": 53 * steps},
          f"fed launches {launches}, want 48 + 48 bn_act and 53 + 53 "
          f"moments per step")
    check(all(np.isfinite(losses))
          and np.isfinite(history[0]["train"]["loss"]), "non-finite fed loss")
    for i, (host, dev_sums) in enumerate(zip(kept, consumed)):
        check(host["image"].shape == (TRAIN_BATCH, 112, 112, 12)
              and host["image"].dtype == np.float32, "fed batch layout")
        want = (host_checksum(host["image"], host_weights),
                host_checksum(host["label"], host_weights))
        got = tuple(tuple(int(v) for v in d.tolist()) for d in dev_sums)
        check(got == want, f"batch {i}: the step consumed checksums {got} "
              f"on the card, the loader yielded {want}")
    print(f"[feed] placement check ({encoding}): {len(kept)} of "
          f"{len(kept)} batches bitwise equal on the card to the host "
          f"batches the loader yielded (image and label checksums), with "
          f"every copy held back {COPY_HOLD_CYCLES} cycles and every read "
          f"{READ_HOLD_CYCLES}")
    del kept, consumed

    rows = {mode_name(mode): timed_epoch(torch, trainer, pattern, encoding,
                                         mode, counters, place, card)
            for mode in feed_modes(encoding)}
    print(f"[feed] fed step ({encoding}) by worker mode, ms/step: "
          f"{ {k: round(v, 3) for k, v in rows.items()} }; the fixed batch "
          f"of phase 5: {step_ms[0]:.3f} ms/step (CUDA events), "
          f"{step_ms[1]:.3f} (wall) ({card})")
    del trainer, loader
    torch.cuda.empty_cache()


def mode_name(mode):
    return (f"{mode['num_procs']} processes" if mode.get("num_procs")
            else f"{mode['num_workers']} threads")


def timed_epoch(torch, trainer, pattern, encoding, mode, counters, place,
                card):
    """One epoch of Trainer.fit over a loader with `mode`'s workers:
    returns ms/step from the first step to the last; prints the host's
    time in each train_step (issue, and the issuing thread's CPU time),
    the feed's counters, host ms a _place_one and the caching host
    allocator's pinned blocks."""
    from deep_vision_tpu_torch.tools.profile_train import make_record_loader

    loader = make_record_loader(pattern, encoding=encoding, **mode)
    steps = FEED_IMAGES // TRAIN_BATCH
    before = {k: c.value for k, c in counters.items()}
    place_before = (place.count, place.mean)
    allocs_before = torch.cuda.host_memory_stats()["num_host_alloc"]
    entries, issue, cpu = [], [], []
    train_step = trainer.train_step

    def timed_step(batch):
        entries.append(time.perf_counter())
        c0 = time.thread_time()
        metrics = train_step(batch)
        issue.append((time.perf_counter() - entries[-1]) * 1e3)
        cpu.append((time.thread_time() - c0) * 1e3)
        return metrics

    trainer.train_step = timed_step
    torch.cuda.synchronize()
    history = trainer.fit(lambda: loader)
    torch.cuda.synchronize()
    trainer.train_step = train_step
    check(len(entries) == steps and np.isfinite(history[0]["train"]["loss"]),
          f"timed epoch: {len(entries)} steps, history {history}")
    ms = (entries[-1] - entries[0]) * 1e3 / (steps - 1)
    delta = {k: c.value - before[k] for k, c in counters.items()}
    n_place = place.count - place_before[0]
    place_ms = (place.mean * place.count
                - place_before[1] * place_before[0]) / n_place
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    print(f"[feed] fed step ({encoding}, {mode_name(mode)}, device_prefetch "
          f"{FEED_DEPTH}): {ms:.3f} ms/step from the first step to the last "
          f"of Trainer.fit ({TRAIN_BATCH / ms * 1e3:.1f} images/s); the host "
          f"in train_step {statistics.median(issue):.3f} ms a step (median; "
          f"the issuing thread's CPU time {statistics.median(cpu):.3f}); "
          f"counters {delta}; _place_one {place_ms:.3f} ms a batch on the "
          f"host (mean of {n_place}); pinned blocks allocated "
          f"{allocs - allocs_before} for {2 * steps} pins ({card})")
    check(delta["data_batches_total"] == steps, f"batches {delta}")
    check(allocs - allocs_before < 2 * steps,
          f"the caching host allocator reused no pinned block: "
          f"{allocs_before} -> {allocs} over {2 * steps} pins")
    return ms


def h2d_time(torch, dev, card):
    """Host ms to pin one fed image batch and the copy stream's ms to copy
    it, medians of 10."""
    stream = torch.cuda.Stream(dev)
    x = np.random.default_rng(0).random(
        (TRAIN_BATCH, 112, 112, 12), dtype=np.float32)
    pins, copies = [], []
    for _ in range(13):
        t = time.perf_counter()
        pinned = torch.from_numpy(x).pin_memory()
        pins.append((time.perf_counter() - t) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record()
            y = pinned.to(dev, non_blocking=True)
            end.record()
        end.synchronize()
        copies.append(start.elapsed_time(end))
        check(torch.equal(y.cpu(), pinned), "h2d copy differs")
    ms = statistics.median(copies[3:])
    print(f"[feed] one {tuple(x.shape)} float32 batch ({x.nbytes / 1e6:.1f} "
          f"MB): pin_memory {statistics.median(pins[3:]):.3f} ms on the "
          f"host, copy {ms:.3f} ms on the copy stream "
          f"({x.nbytes / ms / 1e6:.1f} GB/s), medians of 10 ({card})")


def feed_phase(torch, dev, step_ms, card):
    """Phase 5b: the flagship step fed from record shards."""
    from deep_vision_tpu_torch.data.native_build import library_path
    from deep_vision_tpu_torch.ops.cuda.build import BUILD_DIR
    from deep_vision_tpu_torch.tools.synth_records import write_synth_records

    variants, why = feed_variants()
    print(f"[feed] os.cpu_count() {os.cpu_count()}, usable "
          f"{len(os.sched_getaffinity(0))}; variants {list(variants)}: {why}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for encoding in variants:
            t0 = time.perf_counter()
            paths = write_synth_records(os.path.join(tmp, encoding),
                                        FEED_IMAGES, FEED_SIZE, FEED_SHARDS,
                                        encoding)
            size = sum(os.path.getsize(p) for p in paths)
            print(f"[feed] wrote {FEED_IMAGES} {encoding} records, "
                  f"{size} bytes in {len(paths)} shards, in "
                  f"{time.perf_counter() - t0:.2f} s (native library "
                  f"{library_path().name})")
            pattern = os.path.join(tmp, encoding, "*")
            host_chain(pattern, encoding, card)
            fed_epochs(torch, dev, pattern, encoding, step_ms, card)
    h2d_time(torch, dev, card)


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



#: phase 6: the training CLI's config, data and runs
CLI_CONFIG = "resnet50"
CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, CLI_SIZE = 1024, 256, 256
CLI_TRAIN_SHARDS, CLI_VAL_SHARDS = 8, 2
CLI_EPOCHS = 2
#: seconds a CLI run may take (process start, native build, 2 epochs)
CLI_TIMEOUT = 420
#: the SIGTERM run is signalled after this many steps of its first epoch
CLI_SIGTERM_AFTER = 1
#: the first step's loss, CLI subprocess against the in-process Trainer
#: on the same batch (both TF32 convolutions, other cuDNN algorithms)
CLI_LOSS_RTOL = 1e-3
#: timed fixed-batch steps, with the skip policy off and on
CLI_POLICY_STEPS = 5
#: phase 6's hook, imported by the CLI runs as sitecustomize: checksums
#: of every batch Trainer.train_step reads (label (or detection class, or
#: pose keypoint) and image sums weighted by row, in float64 on the card,
#: read at exit)
#: and the kernel wrappers' launch counts over the run, set to 0 before
#: the CLI starts, written as JSON at exit: bn_act and the moments under
#: "launches", NMS under "nms", LayerNorm's forward and backward under
#: "layer_norm"
BATCH_HOOK = """
import atexit, json, os
_path = os.environ.get("SMOKE_BATCH_LOG")
if _path:
    import torch
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments, layer_norm
    from deep_vision_tpu_torch.train import trainer as _trainer
    fused_scale_bias_act.launches = 0
    fused_scale_bias_act.backward_launches = 0
    batch_moments.launches = 0
    batch_moments.backward_launches = 0
    greedy_nms.launches = 0
    layer_norm.launches = 0
    layer_norm.backward_launches = 0
    _rows = []
    _train_step = _trainer.Trainer.train_step

    def _logged(self, batch):
        data = self._on_device(batch)
        label = next(data[k] for k in ("label", "classes", "keypoints")
                     if k in data)
        n = label.shape[0]
        w = torch.arange(1, n + 1, dtype=torch.float64, device=label.device)
        img = data[self.input_key].double().reshape(n, -1).sum(1)
        _rows.append((self.state.step,
                      (label.double().reshape(n, -1).sum(1) * w).sum(),
                      (img * w).sum()))
        return _train_step(self, data)

    _trainer.Trainer.train_step = _logged

    def _dump():
        launches = {
            "bn_act_fwd": fused_scale_bias_act.launches,
            "bn_act_bwd": fused_scale_bias_act.backward_launches,
            "bn_moments_fwd": batch_moments.launches,
            "bn_moments_bwd": batch_moments.backward_launches}
        with open(_path, "w") as f:
            json.dump({"batches": [[s, float(a), float(b)]
                                   for s, a, b in _rows],
                       "launches": launches, "nms": greedy_nms.launches,
                       "layer_norm": [layer_norm.launches,
                                      layer_norm.backward_launches]}, f)

    atexit.register(_dump)
"""


def cli_command(data, ckpt, journal, epochs, *extra, config=CLI_CONFIG):
    """Phase 6's CLI runs; another `config` runs as a user would, without
    the skip_step policy."""
    policy = (["--health-policy", "skip_step"] if config == CLI_CONFIG
              else [])
    return [sys.executable, "-m", "deep_vision_tpu_torch.train_cli", "-m",
            config, "--data-dir", data, "--ckpt-dir", ckpt, "--epochs",
            str(epochs), "--data-snapshot", "--journal", journal, *policy,
            *extra]


def run_cli(cmd, env, log, label):
    """Run one CLI process to its end; fail with its output's tail."""
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=out,
                              stderr=subprocess.STDOUT, timeout=CLI_TIMEOUT)
    secs = time.perf_counter() - t0
    tail = open(log).read()[-3000:]
    check(proc.returncode == 0,
          f"CLI run {label} exited {proc.returncode}:\n{tail}")
    print(f"[cli] run {label}: exit 0 in {secs:.1f} s")
    return secs


def cli_report(rows, label, card, tag="[cli]", metric="top1"):
    """Print a CLI run's numbers from its journal: ms/step (the step
    events' host timestamps within an epoch of one process, each epoch's
    first step left out), images/s,
    peak memory, save and restore times, LR and the val `metric` by
    epoch."""
    steps = [r for r in rows if r["event"] == "step"]
    runs = list(dict.fromkeys(r["run_id"] for r in steps))
    timed = [((b["ts"] - a["ts"]) * 1e3, b["step"], runs.index(b["run_id"]))
             for a, b in zip(steps, steps[1:])
             if a["epoch"] == b["epoch"] and a["run_id"] == b["run_id"]]
    gaps = [g for g, _, _ in timed]
    evals = {r["epoch"]: r["summary"] for r in rows if r["event"] == "eval"}
    lr = {}
    for r in steps:
        lr.setdefault(r["epoch"], r["lr"])
    saves = [r["save_ms"] for r in rows if r["event"] == "checkpoint"]
    written = [r for r in rows if r.get("note") == "checkpoint_written"]
    restores = [r["restore_ms"] for r in rows if r.get("note") == "resumed"]
    peak = [r["bytes"] for r in rows if r.get("note") == "peak_memory"]
    batch = steps[0]["examples"] if steps else 0
    ms = statistics.median(gaps) if gaps else float("nan")
    print(f"{tag} {label}: {len(steps)} steps of {batch}, "
          f"{ms:.3f} ms/step median ({min(gaps or [0]):.3f}-"
          f"{max(gaps or [0]):.3f}; the journal's step timestamps, host "
          f"clock), {batch / ms * 1e3:.1f} images/s; peak device memory "
          f"{peak[0] / 2**30 if peak else float('nan'):.2f} GiB; save "
          f"blocking {saves} ms, written "
          f"{[round(r['write_ms'], 1) for r in written]} ms "
          f"({[r['bytes'] for r in written]} bytes); restore {restores} ms; "
          f"lr by epoch {lr}; val {metric} by epoch "
          f"{ {e: round(v[metric], 5) for e, v in evals.items()} } ({card})")
    if timed:
        g, step, proc = max(timed)
        print(f"{tag} {label}: the longest step gap, {g:.3f} ms, ends at "
              f"step {step}, in process {proc + 1} of {len(runs)} (steps a "
              f"process: {[sum(r['run_id'] == k for r in steps) for k in runs]}"
              f")")
    return steps, ms


def bn_act_fwd_case(torch, x, a, b, r, tag):
    """One bn_act forward call against its plain version, bit for bit,
    both timed. -> (the plain result, kernel ms, plain ms, bytes, ops)."""
    from deep_vision_tpu_torch.ops.cuda.bn_act import (
        bn_act_forward,
        bn_act_plain,
    )

    y, yp = bn_act_forward(x, a, b, r, "relu"), bn_act_plain(
        x, a, b, r, "relu")
    check(torch.equal(y, yp),
          f"{tag} bn_act forward differs: {tuple(x.shape)}")
    t, t_plain = (time_cuda(torch, fn, runs=10)[0] for fn in (
        lambda: bn_act_forward(x, a, b, r, "relu"),
        lambda: bn_act_plain(x, a, b, r, "relu")))
    nbytes = (2 + (r is not None)) * x.numel() * 4 + 8 * x.shape[1]
    return yp, t, t_plain, nbytes, BN_FWD_OPS * x.numel()


def f32_step_kernels(torch, dev, model, images, card, counts=(48, 53),
                     tag="[cli]"):
    """A float32 step's kernel instances at its batch: every bn_act and
    moments call of one step of `model` on `images` against its plain
    version (forward, dx and the moments backward bitwise; dscale, dbias
    and the moments within BN_SUM_TOL / NORM_SUM_TOL x sum|terms|; the
    moments also bitwise against moments_order_model, repeating), with
    kernel,
    plain and bound times summed over the step's calls, and the library
    calls beside the moments (LIBRARY_CALL), and each moments shape's
    times and host us a call. `counts`: the step's (bn_act, moments) call
    counts. Returns the per-kernel sums, with the largest |kernel -
    plain| of each."""
    from deep_vision_tpu_torch.ops.cuda.bn_act import (
        bn_act_backward,
        bn_act_bwd_plain,
    )
    from deep_vision_tpu_torch.ops.cuda.norm import (
        bn_moments_backward,
        bn_moments_bwd_coefficients,
        bn_moments_bwd_plain,
        bn_moments_forward,
        bn_moments_plain,
        moments_rows,
    )

    calls, moments = batchnorm_calls(torch, model, images)
    gen = torch.Generator(device=dev).manual_seed(6)
    tot = {k: dict(calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0,
                   ops=0, max_abs_err=0.0, host_ms=0.0)
           for k in ("bn_act_fwd", "bn_act_bwd", "bn_moments_fwd",
                     "bn_moments_bwd")}

    def add(name, n, t, t_plain, nbytes, ops, t_library=0.0, host_us=0.0):
        row = tot[name]
        row["calls"] += n
        row["ms"] += n * t
        row["plain_ms"] += n * t_plain
        row["library_ms"] += n * t_library
        row["bytes"] += n * nbytes
        row["ops"] += n * ops
        row["host_ms"] += n * host_us / 1e3

    def draw(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x.contiguous(memory_format=torch.channels_last)
                if len(shape) == 4 else x)

    for (shape, res), n in sorted(calls.items()):
        c = shape[1]
        x, g = draw(shape), draw(shape)
        r = draw(shape) if res else None
        a = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev)
        yp, *fwd = bn_act_fwd_case(torch, x, a, b, r, "f32")
        add("bn_act_fwd", n, *fwd)
        got = bn_act_backward(x, a, yp, g, "relu", res)
        want = bn_act_bwd_plain(x, a, yp, g, "relu", res)
        check(torch.equal(got[0], want[0])
              and (not res or torch.equal(got[3], want[3])),
              f"f32 bn_act dx/dres differ: {shape}")
        gf = torch.where(yp > 0, g, 0.0)
        for k, terms in ((1, (gf * x).abs().sum((0, 2, 3))),
                         (2, gf.abs().sum((0, 2, 3)))):
            check(bool(((got[k] - want[k]).abs()
                        <= BN_SUM_TOL * terms).all()),
                  f"f32 bn_act dscale/dbias beyond tolerance: {shape}")
            tot["bn_act_bwd"]["max_abs_err"] = max(
                tot["bn_act_bwd"]["max_abs_err"],
                float((got[k] - want[k]).abs().max()))
        times = [time_cuda(torch, fn, runs=10)[0] for fn in (
            lambda: bn_act_backward(x, a, yp, g, "relu", res),
            lambda: bn_act_bwd_plain(x, a, yp, g, "relu", res))]
        add("bn_act_bwd", n, *times, (4 + res) * x.numel() * 4 + 12 * c,
            BN_BWD_OPS * x.numel())
        del x, g, r, yp, got, want, gf
    for shape, n in sorted(moments.items()):
        x = draw(shape)
        rows, c = moments_rows(x), shape[1]
        got, want = bn_moments_forward(x), bn_moments_plain(x)
        check(all(torch.equal(g, a) for g, a in zip(got, bn_moments_forward(
            x))), f"f32 moments forward does not repeat: {shape}")
        plan = check_moments_model(torch, x, got, f"{tag} {shape}")
        xd = (x.permute(0, 2, 3, 1).reshape(rows, c) if x.dim() == 4
              else x).double()
        for k, terms in ((0, xd.abs().sum(0)), (1, xd.square().sum(0))):
            e = (got[k].double() - want[k].double()).abs() * rows
            check(bool((e <= NORM_SUM_TOL * terms).all()),
                  f"f32 moments beyond tolerance: {shape}")
            tot["bn_moments_fwd"]["max_abs_err"] = max(
                tot["bn_moments_fwd"]["max_abs_err"],
                float((got[k] - want[k]).abs().max()))
        u = torch.randn(c, generator=gen, device=dev)
        w = torch.randn(c, generator=gen, device=dev)
        coef = bn_moments_bwd_coefficients(rows, u, w)
        dx = bn_moments_backward(x, u, w)
        check(torch.equal(dx, bn_moments_bwd_plain(x, *coef))
              and torch.equal(dx, bn_moments_backward(x, u, w)),
              f"f32 moments backward differs or does not repeat: {shape}")
        alpha, beta = (t.view((1, -1) + (1,) * (x.dim() - 2))
                       for t in coef)
        times, host = zip(*(time_cuda(torch, fn, runs=10) for fn in (
            lambda: bn_moments_forward(x), lambda: bn_moments_plain(x),
            lambda: bn_moments_backward(x, u, w),
            lambda: bn_moments_bwd_plain(x, *coef),
            lambda: torch.batch_norm_stats(x, 1e-5),
            lambda: torch.addcmul(alpha, beta, x, out=torch.empty_like(x)))))
        size = x.numel() * 4
        add("bn_moments_fwd", n, times[0], times[1], size + 8 * c,
            MOMENTS_FWD_OPS * x.numel(), times[4], host[0])
        add("bn_moments_bwd", n, times[2], times[3], 2 * size + 8 * c,
            MOMENTS_BWD_OPS * x.numel(), times[5], host[2])
        fwd_bound = bound_of(size + 8 * c, MOMENTS_FWD_OPS * x.numel())[0]
        bwd_bound = bound_of(2 * size + 8 * c,
                             MOMENTS_BWD_OPS * x.numel())[0]
        print(f"{tag} moments {shape} ({rows} rows of {c}) x{n} a step, a "
              f"call: fwd {times[0]:.4f} ms (bound {fwd_bound:.4f}, "
              f"{100 * fwd_bound / times[0]:.1f}%; plain {times[1]:.4f}, "
              f"{LIBRARY_CALL['bn_moments_fwd']} {times[4]:.4f}; host "
              f"{host[0]:.1f} us; {plan.clusters} clusters of {plan.cluster} "
              f"x {plan.chunks} chunks), bwd "
              f"{times[2]:.4f} ms (bound {bwd_bound:.4f}, "
              f"{100 * bwd_bound / times[2]:.1f}%; plain {times[3]:.4f}, "
              f"{LIBRARY_CALL['bn_moments_bwd']} {times[5]:.4f}; host "
              f"{host[2]:.1f} us) ({card})")
        del x, xd, got, want, dx
    for name, row in tot.items():
        if not row["calls"]:
            continue
        bound_ms, bound_by = bound_of(row["bytes"], row["ops"])
        row["bound_ms"] = bound_ms
        library = (f"{LIBRARY_CALL[name]} {row['library_ms']:.4f} ms"
                   if name in LIBRARY_CALL else "none")
        host = (f"; host {1e3 * row['host_ms'] / row['calls']:.1f} us a "
                f"call" if name in LIBRARY_CALL else "")
        print(f"{tag} float32 batch {images.shape[0]}: {name} over one "
              f"step's {row['calls']} calls: kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / row['ms']:.1f}% of the "
              f"bound; library {library}{host} ({card})")
    check((tot["bn_act_fwd"]["calls"], tot["bn_moments_fwd"]["calls"])
          == tuple(counts),
          f"{tag} the step should make {counts[0]} bn_act and {counts[1]} "
          f"moments calls, got {tot['bn_act_fwd']['calls']} and "
          f"{tot['bn_moments_fwd']['calls']}")
    return tot


def cli_inprocess(torch, dev, data, first_loss, card):
    """The CLI's route in this process (build_dataloaders, build_trainer):
    its first batch's step loss against the CLI run's first step, the
    float32 kernel instances at the batch's shapes, and the step timed
    with the skip_step policy off and on (a fixed batch, CUDA events)."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.obs.health import HealthMonitor
    from deep_vision_tpu_torch.train_cli import (
        build_dataloaders,
        build_trainer,
    )

    cfg = get_config(CLI_CONFIG)
    train_fn, _ = build_dataloaders(cfg, data, False, 0, 8)
    batch = next(iter(train_fn()))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the CLI keeps the default
    try:
        step_ms = {}
        for policy in (None, "skip_step"):
            health = HealthMonitor(policy) if policy else None
            trainer = build_trainer(cfg, train_fn, None, health=health,
                                    steps_per_epoch=1, device=dev)
            placed = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            if policy is None:
                loss = float(trainer.train_step(placed)["loss"])
                err = abs(loss - first_loss) / abs(first_loss)
                print(f"[cli] first step's loss: CLI subprocess "
                      f"{first_loss:.6f}, in-process Trainer "
                      f"{loss:.6f}, relative difference {err:.2e} "
                      f"(tolerance {CLI_LOSS_RTOL})")
                check(err <= CLI_LOSS_RTOL, "the CLI's first step loss "
                      "differs from the in-process Trainer's")
                f32_step_kernels(torch, dev, trainer.model, placed["image"],
                                 card)
            events = []
            for i in range(2 + CLI_POLICY_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                trainer.train_step(placed)
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            step_ms[policy or "off"] = statistics.median(
                s.elapsed_time(e) for s, e in events[2:])
            del trainer, placed
            torch.cuda.empty_cache()
        print(f"[cli] fixed-batch float32 step of {cfg.batch_size}: skip "
              f"policy off {step_ms['off']:.3f} ms, skip_step "
              f"{step_ms['skip_step']:.3f} ms (median of "
              f"{CLI_POLICY_STEPS}, CUDA events) ({card})")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def cli_records(tmp):
    """Phases 6 and 7's seeded JPEG records under `tmp`/data, and the
    batch hook as sitecustomize under `tmp`/hook. -> (data dir, the
    environment of a hooked run, of a deterministic one)."""
    from deep_vision_tpu_torch.tools.synth_records import write_synth_records

    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    write_synth_records(os.path.join(data, "tfrecord_train"),
                        CLI_TRAIN_IMAGES, CLI_SIZE, CLI_TRAIN_SHARDS,
                        "jpeg", seed=0)
    write_synth_records(os.path.join(data, "tfrecord_val"),
                        CLI_VAL_IMAGES, CLI_SIZE, CLI_VAL_SHARDS,
                        "jpeg", seed=1)
    print(f"[cli] wrote {CLI_TRAIN_IMAGES} + {CLI_VAL_IMAGES} seeded "
          f"{CLI_SIZE}x{CLI_SIZE} JPEG records in "
          f"{time.perf_counter() - t0:.1f} s")
    hook = os.path.join(tmp, "hook")
    os.makedirs(hook)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(BATCH_HOOK)
    env = dict(os.environ, PYTHONPATH=hook + os.pathsep + ROOT)
    det = dict(env, DVT_DETERMINISTIC="1", CUBLAS_WORKSPACE_CONFIG=":4096:8")
    return data, env, det


def run_s_black_box(rows, trace_path, flight_dir, card):
    """Phase 6: run S's `--trace` file parses with one `train/step` span
    a journaled step, and its `--flight-dir` holds one `preempt` bundle
    that the port's validate_bundle accepts."""
    from deep_vision_tpu_torch.obs.flight import find_bundles, validate_bundle

    spans = spans_of(trace_path)
    steps = [r for r in rows if r["event"] == "step"]
    n_spans = sum(e["name"] == "train/step" for e in spans)
    check(n_spans == len(steps) > 0, f"run S: {n_spans} train/step spans, "
          f"{len(steps)} steps")
    bundles = find_bundles(flight_dir)
    check(len(bundles) == 1 and bundles[0].endswith("-preempt"),
          f"run S's flight bundles: {bundles}")
    errors = validate_bundle(bundles[0])
    check(errors == [], f"run S's preempt bundle: {errors}")
    check(any(r["event"] == "flight_dump" and r["reason"] == "preempt"
              for r in rows), "run S journaled no flight_dump")
    names = sorted({e["name"] for e in spans})
    print(f"[cli] run S's black box: {len(spans)} spans ({names}) in "
          f"{os.path.getsize(trace_path)} B of trace, {n_spans} train/step "
          f"for {len(steps)} steps; one valid preempt bundle of "
          f"{bundle_bytes(bundles[0])} B ({card})")


def cli_phase(torch, dev, card, tmp, data, env, det):
    """Phase 6: the training CLI in subprocesses, as a user runs it, on
    `cli_records`' data under `tmp`."""
    from deep_vision_tpu_torch.obs.flight import REQUEUE_EXIT_CODE
    from deep_vision_tpu_torch.obs.journal import read_journal

    def path(name):
        return os.path.join(tmp, name)

    # the user's run: two epochs, timed
    run_cli(cli_command(data, path("ck_t"), path("t.jsonl"), CLI_EPOCHS),
            dict(env, SMOKE_BATCH_LOG=path("t_batches.json")),
            path("t.log"), "T (2 epochs)")
    t_rows = read_journal(path("t.jsonl"))
    steps, _ = cli_report(t_rows, "run T", card)
    n_steps = CLI_EPOCHS * CLI_TRAIN_IMAGES // 256
    check(len(steps) == n_steps, f"run T took {len(steps)} steps, want "
          f"{n_steps}")
    # the kernels of the path, counted in the CLI process: every
    # BatchNorm of a train step takes its moments, and every fused one
    # runs bn_act in the train steps, the eval batches and the
    # Trainer's one sample forward at construction
    evals = CLI_EPOCHS * CLI_VAL_IMAGES // 256
    launches = json.load(open(path("t_batches.json")))["launches"]
    want = {"bn_act_fwd": 48 * (n_steps + evals + 1),
            "bn_act_bwd": 48 * n_steps,
            "bn_moments_fwd": 53 * n_steps,
            "bn_moments_bwd": 53 * n_steps}
    print(f"[cli] run T's kernel launches {launches} over {n_steps} "
          f"steps and {evals} eval batches")
    check(launches == want, f"run T's launches {launches}, want {want}")
    check(all(np.isfinite(r["loss"]) for r in steps), "non-finite loss")
    check(t_rows[-1]["event"] == "exit", "run T's journal has no exit")
    for line in open(path("t.log")).read().splitlines():
        if line.startswith(("precision:", "model ", "peak device")):
            print(f"[cli] run T says: {line}")

    # the resume check: A straight, B in two processes, deterministic
    a_log, b_log = path("a_batches.json"), path("b_batches.json")
    run_cli(cli_command(data, path("ck_a"), path("a.jsonl"), CLI_EPOCHS),
            dict(det, SMOKE_BATCH_LOG=a_log), path("a.log"),
            "A (2 epochs, deterministic)")
    run_cli(cli_command(data, path("ck_b"), path("b.jsonl"), 1),
            dict(det, SMOKE_BATCH_LOG=path("b1_batches.json")),
            path("b1.log"), "B1 (1 epoch, deterministic)")
    run_cli(cli_command(data, path("ck_b"), path("b.jsonl"), CLI_EPOCHS,
                        "-c", path("ck_b")),
            dict(det, SMOKE_BATCH_LOG=b_log), path("b2.log"),
            "B2 (-c, to epoch 2, deterministic)")
    a_rows, b_rows = read_journal(path("a.jsonl")), read_journal(
        path("b.jsonl"))
    cli_report(a_rows, "run A", card)
    cli_report(b_rows, "runs B1 + B2", card)
    resumes = [r for r in b_rows if r["event"] == "data_resume"]
    check([r["verdict"] for r in resumes] == ["restored"],
          f"B2's data_resume events {resumes}")
    batches_a = json.load(open(a_log))["batches"]
    batches_b = json.load(open(b_log))["batches"]
    per_epoch = CLI_TRAIN_IMAGES // 256
    check([r[0] for r in batches_b] == list(range(per_epoch, n_steps)),
          f"B2 read batches at steps {[r[0] for r in batches_b]}")
    check(batches_a[per_epoch:] == batches_b,
          "B2's second epoch did not read A's batches (label and image "
          "checksums)")
    print(f"[cli] resume: B2 read the same {len(batches_b)} batches as "
          f"A's second epoch (label and image checksums equal)")
    sd = {}
    for run in ("a", "b"):
        step_dir = os.path.join(path(f"ck_{run}"), str(n_steps))
        check(os.path.isdir(step_dir), f"run {run} has no checkpoint at "
              f"step {n_steps}")
        sd[run] = torch.load(os.path.join(step_dir, "state.pt"),
                             map_location="cpu", weights_only=True)
    check(sd["a"]["step"] == sd["b"]["step"] == n_steps,
          f"steps {sd['a']['step']} and {sd['b']['step']}")
    diff = {k: float((v.double() - sd["b"]["model"][k].double()).abs()
                     .max()) for k, v in sd["a"]["model"].items()}
    mom = {}
    for k, st in sd["a"]["optimizer"]["state"].items():
        for name, v in st.items():
            if torch.is_tensor(v):
                w = sd["b"]["optimizer"]["state"][k][name]
                mom[f"{k}.{name}"] = float((v.double() - w.double())
                                           .abs().max())
    worst = max(list(diff.values()) + list(mom.values()))
    print(f"[cli] final state A vs B: {len(diff)} model tensors, "
          f"{len(mom)} optimizer tensors, largest difference {worst}")
    largest = sorted(((v, k) for k, v in {**diff, **mom}.items()),
                     reverse=True)[:5]
    check(worst == 0.0 and sd["a"]["optimizer"]["param_groups"]
          == sd["b"]["optimizer"]["param_groups"],
          f"the resumed run is not bitwise equal to the straight one: "
          f"{largest}")
    first_loss = next(r["loss"] for r in a_rows if r["event"] == "step")

    # SIGTERM mid-epoch, traced and with a flight recorder, then a resume
    # that completes
    s_journal = path("s.jsonl")
    s_trace, s_flight = path("s.trace.json"), path("s_flight")
    with open(path("s.log"), "w") as out:
        proc = subprocess.Popen(
            cli_command(data, path("ck_s"), s_journal, CLI_EPOCHS,
                        "--trace", s_trace, "--flight-dir", s_flight),
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=out,
            stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + CLI_TIMEOUT
            while time.time() < deadline and proc.poll() is None:
                if os.path.exists(s_journal) and sum(
                        r["event"] == "step"
                        for r in read_journal(s_journal)) \
                        >= CLI_SIGTERM_AFTER:
                    break
                time.sleep(0.2)
            check(proc.poll() is None, "run S ended before its SIGTERM")
            proc.send_signal(signal.SIGTERM)
            t_term = time.perf_counter()
            rc = proc.wait(timeout=CLI_TIMEOUT)
            t_term = time.perf_counter() - t_term
        finally:
            if proc.poll() is None:
                proc.kill()
    s_rows = read_journal(s_journal)
    pre = [r for r in s_rows if r["event"] == "preempt_checkpoint"]
    check(rc == REQUEUE_EXIT_CODE and len(pre) == 1 and pre[0]["saved"],
          f"SIGTERM run: exit {rc} (want {REQUEUE_EXIT_CODE}), preempt "
          f"events {pre}:\n{open(path('s.log')).read()[-3000:]}")
    print(f"[cli] run S: SIGTERM after {CLI_SIGTERM_AFTER} steps; exit "
          f"{rc} (the requeue code) after a preempt save at step "
          f"{pre[0]['step']}, {t_term:.1f} s after the signal")
    run_s_black_box(s_rows, s_trace, s_flight, card)
    run_cli(cli_command(data, path("ck_s"), s_journal, CLI_EPOCHS, "-c",
                        path("ck_s")), dict(os.environ, PYTHONPATH=ROOT),
            path("s2.log"), "S2 (-c after SIGTERM)")
    s_rows = read_journal(s_journal)
    cli_report(s_rows, "runs S + S2", card)
    s_steps = [r["step"] for r in s_rows if r["event"] == "step"]
    check(s_steps == list(range(1, n_steps + 1)),
          f"the SIGTERM run and its resume took steps {s_steps}")
    check(os.path.isdir(os.path.join(path("ck_s"), str(n_steps))),
          "the resumed SIGTERM run saved no final checkpoint")
    torch.cuda.empty_cache()
    cli_inprocess(torch, dev, data, first_loss, card)


#: phase 7: the classifier zoo, each config as registered (float32), and
#: its (fused, training) BatchNorms a training step: bn_act forward and
#: backward launches, moments forward and backward launches
#: (tests/test_torch_zoo_models.py counts them on the CPU)
ZOO_BN = {"lenet5": (0, 0), "alexnet1": (0, 0), "alexnet2": (0, 0),
          "vgg16": (0, 0), "vgg19": (0, 0), "inception1": (0, 59),
          "inception3": (0, 96), "resnet50v2": (16, 49),
          "mobilenet1": (27, 27), "shufflenet1": (17, 49)}
ZOO_WARMUP, ZOO_STEPS = 2, 5
#: the card-against-CPU step's batch: 8 where BatchNorms take batch
#: statistics (their deviation over fewer rows magnifies the two sides'
#: summation differences), else 2
ZOO_CHECK_BATCH = 8
#: that step's tolerances, CHECK_TOL's rules: the loss relative; each
#: parameter's gradient and each running statistic relative to its
#: tensor's largest magnitude. The CPU step takes the card step's ReLU
#: and max-pool decisions (BranchReplay): at full width a step has ~1e7
#: ReLU inputs and ~1e6 pool windows, and the few within the two sides'
#: rounding of a tie otherwise fall the other way on one side, each
#: moving one element's gradient by its whole size (VGG-19, no
#: BatchNorm: 7.0e-2 of ConvBN_11's largest gradient; with the ReLUs
#: replayed, 5.5e-2 of ConvBN_15's; on the H100). A fused BatchNorm's
#: scale and bias gradients come from the bn_act backward's sums
#: da = sum g'x and db = sum g' as dscale = (da - mean db) rsqrt(var +
#: eps) and dbias = db, so they may also differ by BN_SUM_TOL x the sums
#: of |terms| carried through that: rsqrt(var + eps) (sum|g'x| + |mean|
#: sum|g'|) and sum|g'| (`fused_sum_bounds`); the subtraction cancels
#: where |mean| >> std (MobileNet's stem: 9.7e-2 of its largest scale
#: gradient; on the H100)
ZOO_CHECK_TOL = {"loss": 1e-4, "grad": 2e-2, "stats": 1e-3}
#: A running mean is held against the larger of its largest magnitude and
#: a tenth of its batch's deviation, the step's own scale for it: where
#: the batch mean is zero in exact arithmetic (ShuffleNet's 1x1 group
#: conv after a zero-mean BatchNorm output) it is rounding noise.
#: Gradients that are zero in exact arithmetic, each held at the grad
#: tolerance of another gradient of its layer: ShuffleNet's depthwise
#: BatchNorm shift, which a 1x1 conv carries into the next training
#: BatchNorm (tests/test_torch_zoo_models.py's CANCELLED)
ZOO_CANCELLED = {"shufflenet1": ("ConvBN_1.BatchNorm_0.bias",
                                 "ConvBN_1.BatchNorm_0.scale")}
#: the zoo's CLI runs: mobilenet1 on phase 6's records, lenet5 on seeded
#: MNIST idx files (train, test images)
ZOO_CLI_CONFIG, ZOO_CLI_EPOCHS = "mobilenet1", 2
ZOO_MNIST = (6000, 1000)


def zoo_launches(torch, fused_scale_bias_act, batch_moments):
    return {"bn_act_fwd": fused_scale_bias_act.launches,
            "bn_act_bwd": fused_scale_bias_act.backward_launches,
            "bn_moments_fwd": batch_moments.launches,
            "bn_moments_bwd": batch_moments.backward_launches}


def zoo_steps(torch, dev, card):
    """Phase 7a and 7c: each zoo config through the CLI's route
    (profile_train's `make_zoo_parts`: `build_trainer` with the
    registered model, optimizer and schedule, at its width, input size,
    batch and float32, on the CLI's seeded fake batch), with the CLI's
    precision (cuDNN TF32 on, matmuls float32):
    warm-up, then timed steps with the kernels counted; for mobilenet1
    and shufflenet1 every bn_act and moments call of a step against its
    plain version. Returns {config: (ms/step, images/s, peak GiB)}."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments
    from deep_vision_tpu_torch.tools.profile_train import make_zoo_parts

    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the CLI keeps the default
    try:
        for name in ZOO_BN:
            cfg = get_config(name)
            base = torch.cuda.memory_allocated()  # what earlier phases hold
            t0 = time.perf_counter()
            trainer, placed = make_zoo_parts(name, device=dev)
            build_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(ZOO_WARMUP):
                trainer.train_step(placed)
            torch.cuda.synchronize()
            fused_scale_bias_act.launches = 0  # the zoo step's run starts
            fused_scale_bias_act.backward_launches = 0
            batch_moments.launches = 0
            batch_moments.backward_launches = 0
            events, losses = [], []
            for _ in range(ZOO_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(trainer.train_step(placed)["loss"])
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            launches = zoo_launches(torch, fused_scale_bias_act,
                                    batch_moments)  # ... and ends here
            ms = statistics.median(a.elapsed_time(b) for a, b in events)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            losses = [float(v) for v in losses]
            fused, stats = ZOO_BN[name]
            want = {"bn_act_fwd": fused * ZOO_STEPS,
                    "bn_act_bwd": fused * ZOO_STEPS,
                    "bn_moments_fwd": stats * ZOO_STEPS,
                    "bn_moments_bwd": stats * ZOO_STEPS}
            n_params = sum(p.numel() for p in trainer.model.parameters())
            ips = cfg.batch_size / ms * 1e3
            print(f"[zoo] {name} ({n_params} parameters, "
                  f"{'x'.join(map(str, cfg.input_shape))}, float32 batch "
                  f"{cfg.batch_size}, {cfg.optimizer['name']}): {ms:.3f} "
                  f"ms/step median of {ZOO_STEPS} (CUDA events), {ips:.1f} "
                  f"images/s, peak memory {peak:.2f} GiB "
                  f"(max_memory_allocated over what was held before); loss "
                  f"{[round(v, 4) for v in losses]}; launches {launches} "
                  f"over {ZOO_STEPS} steps; built in {build_s:.1f} s "
                  f"({card})")
            check(launches == want, f"{name}: launches {launches}, want "
                  f"{want} ({fused} fused and {stats} training BatchNorms "
                  f"a step)")
            check(all(np.isfinite(losses)), f"{name}: non-finite loss")
            out[name] = (ms, ips, peak)
            if name in ("mobilenet1", "shufflenet1"):
                f32_step_kernels(torch, dev, trainer.model, placed["image"],
                                 card, counts=(fused, stats),
                                 tag=f"[zoo] {name}")
            del trainer, placed
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


class BranchReplay:
    """Record every ReLU decision (`F.relu`, a ConvBN's unfused ReLU, the
    ReLU inside bn_act, Darknet's leaky ReLU, `F.leaky_relu` (the GANs'))
    and every max pool's choice
    (`F.max_pool2d`) of one forward, and impose them, in call order, on
    a second forward of the same model: there each ReLU keeps its input
    where the first run's input was positive (a leaky one scales the rest
    by its slope), and each pool takes the element the first run's pool
    took. The second run's gradients then flow where the first run's
    did."""

    def __init__(self, torch):
        import deep_vision_tpu_torch.nn.layers as layers

        self.torch, self.layers, self.f = torch, layers, torch.nn.functional
        from deep_vision_tpu_torch.models import yolov3

        self.relu0, self.pool0 = self.f.relu, self.f.max_pool2d
        self.leaky_relu0 = self.f.leaky_relu
        self.leaky0 = yolov3._leaky
        self.fused0 = layers.fused_scale_bias_act
        self.taken, self.replay, self.i = [], False, 0

    def _take(self, choice):
        if not self.replay:
            self.taken.append(choice.cpu())
            return None
        self.i += 1
        return self.taken[self.i - 1]

    def relu(self, x, inplace=False):
        m = self._take(x > 0)
        if m is None:
            return self.relu0(x)
        return self.torch.where(m.to(x.device), x, 0.0)

    def leaky(self, x):
        return self.leaky_relu(x, 0.1)

    def leaky_relu(self, x, negative_slope=0.01, inplace=False):
        m = self._take(x > 0)
        if m is None:
            return self.leaky_relu0(x, negative_slope)
        return self.torch.where(m.to(x.device), x, negative_slope * x)

    def fused(self, x, a, b, residual=None, act=None):
        if act != "relu":
            return self.fused0(x, a, b, residual=residual, act=act)
        if not self.replay:
            y = self.fused0(x, a, b, residual=residual, act=act)
            self._take(y > 0)
            return y
        z = self.fused0(x, a, b, residual=residual, act=None)
        return self.torch.where(self._take(None).to(z.device), z, 0.0)

    def max_pool2d(self, x, *args, **kw):
        if not self.replay:
            y, idx = self.pool0(x, *args, **kw, return_indices=True)
            self._take(idx)
            return y
        idx = self._take(None).to(x.device)
        n, c = idx.shape[:2]
        flat = x.reshape(n, c, -1).gather(2, idx.reshape(n, c, -1))
        fmt = (self.torch.channels_last if x.is_contiguous(
            memory_format=self.torch.channels_last)
            else self.torch.contiguous_format)
        return flat.reshape(idx.shape).contiguous(memory_format=fmt)

    def run(self, model, fn, replay):
        """fn() with the ReLUs and max pools of `model` routed here."""
        from deep_vision_tpu_torch.nn.layers import ConvBN

        self.replay, self.i = replay, 0
        acts = {id(self.relu0): (self.relu0, self.relu),
                id(self.leaky0): (self.leaky0, self.leaky)}
        convbns = [m for m in model.modules()
                   if isinstance(m, ConvBN) and id(m.act) in acts]
        self.f.relu, self.f.max_pool2d = self.relu, self.max_pool2d
        self.f.leaky_relu = self.leaky_relu
        self.layers.fused_scale_bias_act = self.fused
        for m in convbns:
            m.act = acts[id(m.act)][1]
        try:
            return fn()
        finally:
            self.f.relu, self.f.max_pool2d = self.relu0, self.pool0
            self.f.leaky_relu = self.leaky_relu0
            self.layers.fused_scale_bias_act = self.fused0
            for m in convbns:
                m.act = (self.relu0 if m.act == self.relu
                         else self.leaky0)


def fused_sum_bounds(torch, model):
    """Hooks on `model`'s fused BatchNorms that record, over one training
    step, the sums of |terms| behind each one's scale and bias gradient
    (see ZOO_CHECK_TOL). -> ({parameter name: per-channel bound}, the
    hook handles)."""
    from deep_vision_tpu_torch.nn.layers import BatchNorm

    bounds, handles = {}, []
    for name, m in model.named_modules():
        if not (isinstance(m, BatchNorm) and m.act is not None):
            continue

        def forward(mod, args, out, name=name):
            x = args[0].detach().double()
            dims = (0, 2, 3)
            mean = x.mean(dims)
            r = (x.square().mean(dims) - mean.square()).clamp_min(0.0).add(
                mod.epsilon).rsqrt()

            def grad(g):
                gp = torch.where(out > 0, g, 0.0).double()
                a = (gp * x).abs().sum(dims)
                b = gp.abs().sum(dims)
                bounds[f"{name}.scale"] = (r * (a + mean.abs() * b)).cpu()
                bounds[f"{name}.bias"] = b.cpu()

            out.register_hook(grad)

        handles.append(m.register_forward_hook(forward))
    return bounds, handles


def card_cpu_shares(lk, lp, grads, stats, tol, bounds=None,
                    cancelled=None):
    """Each error of a card step against its CPU step as a share of what
    its tolerance allows (ZOO_CHECK_TOL's rules): the loss relative; each
    gradient relative to its tensor's largest magnitude (with `bounds`,
    {name: per-channel bound}, added: the fused BatchNorms' sums of
    |terms|; a `cancelled` (suffix, reference suffix) gradient against
    its reference's largest magnitude); each running mean against the
    larger of its largest magnitude and a tenth of its batch deviation,
    each other statistic against its largest magnitude. grads and stats
    are (card, cpu) dicts. -> (shares by kind, the worst tensor's name
    by kind)."""
    share = {"loss": abs(lk - lp) / abs(lp) / tol["loss"], "grad": 0.0,
             "stats": 0.0}
    where = {}
    for kind, (got, want) in (("grad", grads), ("stats", stats)):
        for k in want:
            scale = float(want[k].abs().max())
            if kind == "grad" and cancelled and k.endswith(cancelled[0]):
                scale = float(want[k[:-len(cancelled[0])]
                                   + cancelled[1]].abs().max())
            allowed = tol[kind] * max(scale, 1e-30)
            if kind == "grad" and bounds and k in bounds:
                allowed = allowed + BN_SUM_TOL * bounds[k]
            if kind == "stats" and k.endswith(".mean"):
                # the step moved it by 0.1 x the batch mean, from 0;
                # the batch's own spread moved var from 1
                var = want[k[:-4] + "var"]
                spread = 0.1 * float(((var - 0.9) / 0.1).clamp_min(0.0)
                                     .sqrt().max())
                allowed = tol[kind] * max(scale, spread, 1e-30)
            e = float(((got[k] - want[k]).abs() / allowed).max())
            if e > share[kind]:
                share[kind], where[kind] = e, k
    return share, where


def zoo_against_cpu(torch, dev):
    """Phase 7b: each zoo config's model at its registered width and
    input, one float32 training step (TF32 off) at a small batch on the
    card (kernels) and on the CPU (plain versions) from the same seeded
    weights and batch, dropout off on both (the two devices' generators
    draw different masks), the CPU taking the card's ReLU and max-pool
    decisions (BranchReplay): the loss, every parameter's gradient and
    every running statistic within ZOO_CHECK_TOL."""
    import copy

    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.losses import classification_loss_fn
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.nn.layers import Dropout
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments

    for name in ZOO_BN:
        cfg = get_config(name)
        n = ZOO_CHECK_BATCH if ZOO_BN[name][1] else 2
        rng = np.random.RandomState(7)
        x = rng.rand(n, *cfg.input_shape).astype(np.float32)
        y = rng.randint(0, cfg.num_classes, n).astype(np.int32)
        cpu = get_model(cfg.model, device="cpu", seed=0, train=True,
                        num_classes=cfg.num_classes, **cfg.model_kwargs)
        for m in cpu.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        card_model = copy.deepcopy(cpu).to(dev)
        runs, branches = [], BranchReplay(torch)
        bounds, handles = fused_sum_bounds(torch, card_model)
        for model in (card_model, cpu):
            where = next(model.parameters()).device
            before = zoo_launches(torch, fused_scale_bias_act, batch_moments)
            batch = {"image": torch.from_numpy(x).to(where),
                     "label": torch.from_numpy(y).to(where)}
            loss, _ = branches.run(model, lambda: classification_loss_fn(
                model(batch["image"]), batch), replay=model is cpu)
            loss.backward()
            after = zoo_launches(torch, fused_scale_bias_act, batch_moments)
            runs.append((
                loss.item(),
                {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()},
                {k: b.detach().cpu() for k, b in model.named_buffers()},
                {k: after[k] - before[k] for k in after}))
        for h in handles:
            h.remove()
        (lk, gk, sk, nk), (lp, gp, sp, np_) = runs
        fused, stats = ZOO_BN[name]
        check(nk == {"bn_act_fwd": fused, "bn_act_bwd": fused,
                     "bn_moments_fwd": stats, "bn_moments_bwd": stats}
              and not any(np_.values()),
              f"{name}: card launches {nk}, cpu {np_}")
        check(branches.i == len(branches.taken),
              f"{name}: the CPU step made {branches.i} ReLU and pool calls, "
              f"the card step {len(branches.taken)}")
        check(set(bounds) == {f"{k}.{p}" for k, m in
                              card_model.named_modules()
                              if getattr(m, "act", None) == "relu"
                              for p in ("scale", "bias")},
              f"{name}: sums recorded for {len(bounds)} fused parameters")
        tol = ZOO_CHECK_TOL
        share, where = card_cpu_shares(lk, lp, (gk, gp), (sk, sp), tol,
                                       bounds, ZOO_CANCELLED.get(name))
        print(f"[zoo] {name} float32 batch {n}, card vs CPU "
              f"({len(branches.taken)} ReLU and max-pool calls replayed, "
              f"{len(bounds) // 2} fused BatchNorms): loss {lk:.6f} vs "
              f"{lp:.6f}; the worst error as a share of its tolerance "
              f"{ {k: float(f'{v:.3e}') for k, v in share.items()} } at "
              f"{where}; tolerances {tol} (+ BN_SUM_TOL x the fused "
              f"BatchNorms' sums of |terms|)")
        for kind, e in share.items():
            check(e <= 1.0, f"{name}: card vs CPU {kind} error {e:.3f} of "
                  f"its tolerance ({where.get(kind, kind)})")
        del cpu, card_model, runs
        torch.cuda.empty_cache()


def zoo_cli(torch, card, tmp, data, env, det):
    """Phase 7d and 7e: `train_cli -m mobilenet1` as a user runs it on
    phase 6's records under DVT_DETERMINISTIC=1: run A 2 epochs, run B 1
    epoch then `-c auto` to 2 in a fresh process; B's second epoch must
    read A's batches and end bitwise equal to A (the dropout stream
    included), and A must launch 27 + 27 bn_act and 27 + 27 moments a
    step (bn_act also in eval and the Trainer's sample forward). Then
    `train_cli -m lenet5` one epoch on seeded MNIST idx files. Returns
    mobilenet1's ms/step from A's journal."""
    from deep_vision_tpu_torch.obs.journal import read_journal
    from deep_vision_tpu_torch.tools.synth_mnist import write_synth_mnist

    def path(name):
        return os.path.join(tmp, "zoo_" + name)

    def command(ckpt, journal, epochs, *extra, config=ZOO_CLI_CONFIG,
                data=data):
        return cli_command(data, path(ckpt), path(journal), epochs, *extra,
                           config=config)

    a_log, b_log = path("a_batches.json"), path("b_batches.json")
    run_cli(command("ck_a", "a.jsonl", ZOO_CLI_EPOCHS),
            dict(det, SMOKE_BATCH_LOG=a_log), path("a.log"),
            f"{ZOO_CLI_CONFIG} A ({ZOO_CLI_EPOCHS} epochs, deterministic)")
    run_cli(command("ck_b", "b.jsonl", 1), det, path("b1.log"),
            f"{ZOO_CLI_CONFIG} B1 (1 epoch, deterministic)")
    run_cli(command("ck_b", "b.jsonl", ZOO_CLI_EPOCHS, "-c", "auto"),
            dict(det, SMOKE_BATCH_LOG=b_log), path("b2.log"),
            f"{ZOO_CLI_CONFIG} B2 (-c auto, deterministic)")
    a_rows = read_journal(path("a.jsonl"))
    a_steps, ms = cli_report(a_rows, f"{ZOO_CLI_CONFIG} run A", card,
                             tag="[zoo]")
    cli_report(read_journal(path("b.jsonl")),
               f"{ZOO_CLI_CONFIG} runs B1 + B2", card, tag="[zoo]")
    batch = 128
    per_epoch = CLI_TRAIN_IMAGES // batch
    n_steps, evals = ZOO_CLI_EPOCHS * per_epoch, ZOO_CLI_EPOCHS * (
        CLI_VAL_IMAGES // batch)
    check(len(a_steps) == n_steps, f"run A took {len(a_steps)} steps")
    check(all(np.isfinite(r["loss"]) for r in a_steps), "non-finite loss")
    fused, stats = ZOO_BN[ZOO_CLI_CONFIG]
    launches = json.load(open(a_log))["launches"]
    want = {"bn_act_fwd": fused * (n_steps + evals + 1),
            "bn_act_bwd": fused * n_steps,
            "bn_moments_fwd": stats * n_steps,
            "bn_moments_bwd": stats * n_steps}
    print(f"[zoo] {ZOO_CLI_CONFIG} run A's kernel launches {launches} over "
          f"{n_steps} steps and {evals} eval batches")
    check(launches == want, f"run A's launches {launches}, want {want}")
    batches_a = json.load(open(a_log))["batches"]
    batches_b = json.load(open(b_log))["batches"]
    check(batches_a[per_epoch:] == batches_b,
          "B2's epoch did not read A's second-epoch batches")
    sd = {run: torch.load(os.path.join(path(f"ck_{run}"), str(n_steps),
                                       "state.pt"), map_location="cpu",
                          weights_only=True) for run in ("a", "b")}
    diffs = [float((v.double() - sd["b"]["model"][k].double()).abs().max())
             for k, v in sd["a"]["model"].items()]
    for k, st in sd["a"]["optimizer"]["state"].items():
        for name, v in st.items():
            if torch.is_tensor(v):
                w = sd["b"]["optimizer"]["state"][k][name]
                diffs.append(float((v.double() - w.double()).abs().max()))
    print(f"[zoo] {ZOO_CLI_CONFIG} resume: B2 read A's {len(batches_b)} "
          f"second-epoch batches; final state A vs B: {len(diffs)} "
          f"tensors, largest difference {max(diffs)}")
    check(max(diffs) == 0.0 and sd["a"]["step"] == sd["b"]["step"]
          == n_steps, "the resumed mobilenet1 run is not bitwise equal to "
          "the straight one")

    mnist = path("mnist")
    write_synth_mnist(mnist, *ZOO_MNIST, seed=0)
    run_cli(command("ck_lenet", "lenet.jsonl", 1, config="lenet5",
                    data=mnist), env, path("lenet.log"), "lenet5 (1 epoch)")
    rows = read_journal(path("lenet.jsonl"))
    steps, _ = cli_report(rows, "lenet5", card, tag="[zoo]")
    evals = [r["summary"] for r in rows if r["event"] == "eval"]
    check(len(steps) == -(-ZOO_MNIST[0] // 64) and evals
          and all(np.isfinite(r["loss"]) for r in steps),
          f"lenet5: {len(steps)} steps, eval {evals}")
    print(f"[zoo] lenet5: val top1 {evals[0]['top1']:.4f} after one epoch "
          f"of {ZOO_MNIST[0]} seeded idx images (labels set by a bright "
          f"square's place; chance 0.1)")
    return ms


def zoo_phase(torch, dev, card, tmp, data, env, det):
    """Phase 7: the classifier zoo."""
    t0 = time.perf_counter()
    timed = zoo_steps(torch, dev, card)
    torch.cuda.empty_cache()
    zoo_against_cpu(torch, dev)
    cli_ms = zoo_cli(torch, card, tmp, data, env, det)
    print(f"[zoo] {len(timed)} configs stepped, held against the CPU, and "
          f"{ZOO_CLI_CONFIG} and lenet5 trained through the CLI in "
          f"{time.perf_counter() - t0:.1f} s; {ZOO_CLI_CONFIG} fed CLI "
          f"{cli_ms:.3f} ms/step ({card})")


#: phase 8: vmoe_s16 as registered, its steps, and the LayerNorm calls
#: of one (12 blocks x 2 and the final one, float32 at D = 384)
VMOE_CONFIG, VMOE_WARMUP, VMOE_STEPS = "vmoe_s16", 2, 5
VMOE_LN = 25
#: vmoe_s16's parameters: ViT-S/16 at 224 (22,049,896) with six of its
#: MLPs (1,181,568 each) replaced by 8-expert MoeMlps (9,455,616 each)
VMOE_PARAMS = 71_694_184
#: the card-against-CPU step's batch (392 tokens) and tolerances
#: (VIT_CHECK_TOL's): the card takes the CPU's expert choice where the
#: CPU's top two gates lie within GATE_MARGIN of each other, where a
#: router logit's rounding can move the arg-max
VMOE_CHECK_BATCH = 2
GATE_MARGIN = 1e-5


def vmoe_steps(torch, dev, card):
    """Phase 8a: vmoe_s16 as registered (float32, batch 256, 224, AdamW
    with warmup and cosine) through the CLI's `build_trainer` on the
    CLI's seeded fake batch, with the CLI's precision: warm-up, then
    timed steps with the LayerNorm, moments and flash launches counted
    (25 + 25 LayerNorm a step; no BatchNorm; T = 196 takes the dense
    attention). Returns (the LayerNorm launches, ms/step)."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.ops.cuda.flash_attention import flash_attention
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments, layer_norm
    from deep_vision_tpu_torch.tools.profile_train import make_zoo_parts

    cfg = get_config(VMOE_CONFIG)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the CLI keeps the default
    try:
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trainer, placed = make_zoo_parts(VMOE_CONFIG, device=dev)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(VMOE_WARMUP):
            trainer.train_step(placed)
        torch.cuda.synchronize()
        layer_norm.launches = 0  # the vmoe step's run starts here
        layer_norm.backward_launches = 0
        batch_moments.launches = 0
        flash_attention.launches = 0
        events, metrics = [], []
        for _ in range(VMOE_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics.append(trainer.train_step(placed))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        launches = {"layer_norm_fwd": layer_norm.launches,
                    "layer_norm_bwd": layer_norm.backward_launches,
                    "bn_moments_fwd": batch_moments.launches,
                    "flash_fwd": flash_attention.launches}  # ... ends here
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ms = statistics.median(a.elapsed_time(b) for a, b in events)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n_params = sum(p.numel() for p in trainer.model.parameters())
    seen = {k: [float(m[k]) for m in metrics] for k in (
        "loss", "moe_aux", "router_entropy", "expert_load_max", "top1")}
    print(f"[vmoe] {VMOE_CONFIG} ({n_params} parameters, "
          f"{'x'.join(map(str, cfg.input_shape))}, float32 batch "
          f"{cfg.batch_size}, {cfg.optimizer['name']}): {ms:.3f} ms/step "
          f"median of {VMOE_STEPS} (CUDA events), "
          f"{cfg.batch_size / ms * 1e3:.1f} images/s, peak memory "
          f"{peak:.2f} GiB (max_memory_allocated over what was held "
          f"before); built in {build_s:.1f} s ({card})")
    print(f"[vmoe] by step: " + "; ".join(
        f"{k} {[round(v, 4) for v in vs]}" for k, vs in seen.items())
          + f"; launches {launches} over {VMOE_STEPS} steps")
    check(n_params == VMOE_PARAMS, f"{VMOE_CONFIG} has {n_params} params")
    check(launches == {"layer_norm_fwd": VMOE_LN * VMOE_STEPS,
                       "layer_norm_bwd": VMOE_LN * VMOE_STEPS,
                       "bn_moments_fwd": 0, "flash_fwd": 0},
          f"vmoe launches {launches}, want {VMOE_LN} + {VMOE_LN} LayerNorm "
          f"a step and no moments or flash")
    check(all(np.isfinite(v).all() for v in seen.values()),
          "non-finite vmoe metrics")
    check(all(1 / 8 <= v <= 1.0 for v in seen["expert_load_max"]),
          f"expert_load_max {seen['expert_load_max']} outside [1/E, 1]")
    check(all(0.0 <= v <= np.log(8) + 1e-4 for v in seen["router_entropy"]),
          f"router_entropy {seen['router_entropy']} outside [0, ln E]")
    del trainer, placed
    torch.cuda.empty_cache()
    return launches, ms


def vmoe_against_cpu(torch, dev):
    """Phase 8b: one float32 vmoe_s16 step at VMOE_CHECK_BATCH on the CPU
    (plain versions) and then on the card (kernels), from the same seeded
    weights and batch, TF32 off: loss, grad norm and each parameter's
    gradient within VIT_CHECK_TOL, the card taking the CPU's expert
    choices within GATE_MARGIN (MoeMlp.choose); every MoE block routes
    its tokens to two experts or more, so the grouped dispatch's sort,
    split and inverse-permutation gather run at full width."""
    import copy

    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.losses import classification_loss_fn
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.models.vit import MoeMlp
    from deep_vision_tpu_torch.ops.cuda.norm import layer_norm

    cfg = get_config(VMOE_CONFIG)
    rng = np.random.RandomState(8)
    # zero-mean images, as after the mean/std normalisation: uniform
    # [0, 1) noise shares one large token component, and a block then
    # sends every token to one expert and runs one group
    x = rng.randn(VMOE_CHECK_BATCH, *cfg.input_shape).astype(np.float32)
    y = rng.randint(0, cfg.num_classes, VMOE_CHECK_BATCH).astype(np.int32)
    cpu = get_model(cfg.model, device="cpu", seed=0, train=True,
                    num_classes=cfg.num_classes)
    card_model = copy.deepcopy(cpu).to(dev)
    gates, replayed, groups = {}, {}, ({}, {})

    def record(name):
        def choose(g):
            gates[name] = g.detach().cpu()
            own = g.argmax(dim=-1)
            groups[0][name] = torch.bincount(
                own, minlength=g.shape[-1]).tolist()
            return own
        return choose

    def replay(name):
        def choose(g):
            want = gates[name].argmax(dim=-1).to(g.device)
            top2 = gates[name].topk(2, dim=-1).values
            near = (top2[:, 0] - top2[:, 1] < GATE_MARGIN).to(g.device)
            own = g.argmax(dim=-1)
            differ = own != want
            check(not bool((differ & ~near).any()),
                  f"{name}: the card's expert choice differs from the "
                  f"CPU's beyond a gate margin of {GATE_MARGIN}")
            replayed[name] = int(differ.sum())
            took = torch.where(differ, want, own)
            groups[1][name] = torch.bincount(
                took, minlength=g.shape[-1]).tolist()
            return took
        return choose

    runs = []
    for model, hook in ((cpu, record), (card_model, replay)):
        for name, m in model.named_modules():
            if isinstance(m, MoeMlp):
                m.choose = hook(name)
        where = next(model.parameters()).device
        before = (layer_norm.launches, layer_norm.backward_launches)
        batch = {"image": torch.from_numpy(x).to(where),
                 "label": torch.from_numpy(y).to(where)}
        loss, metrics = classification_loss_fn(model(batch["image"]), batch)
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        runs.append((float(loss.detach()), float(torch.nn.utils.get_total_norm(
            list(grads.values()))), grads,
            {k: float(metrics[k]) for k in ("moe_aux", "router_entropy",
                                            "expert_load_max")},
            (layer_norm.launches - before[0],
             layer_norm.backward_launches - before[1])))
    (lp, gp, dp, mp, np_), (lk, gk, dk, mk, nk) = runs
    check(nk == (VMOE_LN, VMOE_LN) and np_ == (0, 0),
          f"LayerNorm launches card {nk}, cpu {np_}")
    check(len(gates) == 6 and len(replayed) == 6,
          f"MoE blocks: {len(gates)} recorded, {len(replayed)} replayed")
    print(f"[vmoe] tokens per expert in each MoE block, card (CPU): "
          + "; ".join(f"{k.split('.')[0]} {v} ({groups[0][k]})"
                      for k, v in groups[1].items()))
    check(groups[0] == groups[1], "the card's expert groups differ from the "
          "CPU's")
    check(all(sum(n > 0 for n in v) >= 2 for v in groups[1].values()),
          f"an MoE block ran one expert group: {groups[1]}")
    worst = {"loss": abs(lk - lp) / abs(lp),
             "grad_norm": abs(gk - gp) / abs(gp), "grad": 0.0}
    at = ""
    for k in dp:
        e = float((dk[k] - dp[k]).abs().max()) / max(
            float(dp[k].abs().max()), 1e-30)
        if e > worst["grad"]:
            worst["grad"], at = e, k
    print(f"[vmoe] float32 batch {VMOE_CHECK_BATCH} ({VMOE_CHECK_BATCH * 196}"
          f" tokens), card vs CPU: loss {lk:.6f} vs {lp:.6f}, grad_norm "
          f"{gk:.6f} vs {gp:.6f}; router metrics card {mk} cpu {mp}; expert "
          f"choices replayed {sum(replayed.values())} of "
          f"{6 * VMOE_CHECK_BATCH * 196}; worst relative errors {worst} "
          f"(gradient: {at}); tolerances {VIT_CHECK_TOL}")
    for kind, e in worst.items():
        check(e <= VIT_CHECK_TOL[kind], f"vmoe card vs CPU {kind} error "
              f"{e:.3e} > {VIT_CHECK_TOL[kind]}")
    del cpu, card_model
    torch.cuda.empty_cache()


def vmoe_phase(torch, dev, card):
    """Phase 8: V-MoE. Returns (the LayerNorm launches of its run, the
    kernels line's LayerNorm fields at its shapes)."""
    t0 = time.perf_counter()
    launches, ms = vmoe_steps(torch, dev, card)
    rows = layer_norm_cases(
        torch, dev, card, tag="[vmoe]",
        cases=[((256, 196, 384), torch.float32, torch.float32, "normal",
                VMOE_LN)])
    torch.cuda.empty_cache()
    vmoe_against_cpu(torch, dev)
    print(f"[vmoe] {VMOE_CONFIG} stepped, its LayerNorms timed and held "
          f"against the CPU in {time.perf_counter() - t0:.1f} s; "
          f"{ms:.3f} ms/step ({card})")
    return launches, rows


#: phase 9: detection training as registered, on seeded COCO-layout box
#: records converted by tools/convert.py (train, val images of DET_SIZE
#: square), DET_EPOCHS epochs, then --eval-only from its checkpoint
DET_CONFIG, DET_EPOCHS = "yolov3_coco", 2
DET_TRAIN_IMAGES, DET_VAL_IMAGES, DET_SIZE = 128, 64, 480
#: training BatchNorms of a YOLOv3 step (all unfused: Darknet's leaky ReLU
#: follows the BatchNorm), each taking its batch's moments
DET_BN = 72
#: the detector of --eval-only (train_cli.run_eval_only)
DET_SCORE_THR = 0.1
#: the float32 card-against-CPU step: its batch, and ZOO_CHECK_TOL's
#: rules with the loss within 1e-5 relative; the CPU takes the card's
#: leaky-ReLU decisions (BranchReplay) and the card's ignore-mask
#: decisions where the CPU's best IoU lies within IOU_MARGIN of the
#: threshold
DET_CHECK_BATCH = 2
DET_CHECK_TOL = {"loss": 1e-5, "grad": 2e-2, "stats": 1e-3}
IOU_MARGIN = 1e-4


def det_records(tmp):
    """Seeded COCO-layout trees (JPEG files and instances JSON, category
    ids with holes, crowd boxes) through `tools/convert.py coco` into
    records under `tmp`/det_data: 4 train shards, 1 val shard."""
    from deep_vision_tpu_torch.tools import convert
    from deep_vision_tpu_torch.tools.synth_records import write_synth_coco

    root, data = os.path.join(tmp, "coco"), os.path.join(tmp, "det_data")
    t0 = time.perf_counter()
    for split, n, seed, shards in (("train", DET_TRAIN_IMAGES, 0, 4),
                                   ("val", DET_VAL_IMAGES, 1, 1)):
        js, images = write_synth_coco(root, split, n, DET_SIZE, seed=seed)
        check(convert.main(["coco", "--instances-json", js, "--images-dir",
                            images, "--out-dir", data, "--prefix", split,
                            "--num-shards", str(shards), "--workers",
                            "1"]) == 0, f"tools/convert.py coco {split}")
    print(f"[det] wrote {DET_TRAIN_IMAGES} + {DET_VAL_IMAGES} seeded "
          f"{DET_SIZE}x{DET_SIZE} COCO-layout images and converted them "
          f"to records in {time.perf_counter() - t0:.1f} s")
    return data


def det_cli(torch, card, tmp, data, env):
    """Phase 9a: `train_cli -m yolov3_coco` as registered for DET_EPOCHS
    epochs on the converted records (72 + 72 moments launches a step, no
    other kernel), then `--eval-only` from its checkpoint: mAP@.5 and
    mAP@[.5:.95] with one NMS launch a val batch. -> (the checkpoint's
    step dir, its ms/step, train launches, eval NMS launches)."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.obs.journal import read_journal

    def path(name):
        return os.path.join(tmp, "det_" + name)

    base = [sys.executable, "-m", "deep_vision_tpu_torch.train_cli", "-m",
            DET_CONFIG, "--data-dir", data]
    run_cli(base + ["--ckpt-dir", path("ck"), "--epochs", str(DET_EPOCHS),
                    "--journal", path("run.jsonl")],
            dict(env, SMOKE_BATCH_LOG=path("train.json")), path("train.log"),
            f"{DET_CONFIG} ({DET_EPOCHS} epochs)")
    rows = read_journal(path("run.jsonl"))
    steps, ms = cli_report(rows, f"{DET_CONFIG} run", card, tag="[det]",
                           metric="loss")
    batch = get_config(DET_CONFIG).batch_size
    n_steps = DET_EPOCHS * (DET_TRAIN_IMAGES // batch)
    check(len(steps) == n_steps, f"{DET_CONFIG} took {len(steps)} steps")
    check(all(np.isfinite(r["loss"]) for r in steps), "non-finite loss")
    train = json.load(open(path("train.json")))
    want = {"bn_act_fwd": 0, "bn_act_bwd": 0,
            "bn_moments_fwd": DET_BN * n_steps,
            "bn_moments_bwd": DET_BN * n_steps}
    print(f"[det] {DET_CONFIG} run's kernel launches {train['launches']}, "
          f"nms {train['nms']}, layer_norm {train['layer_norm']} over "
          f"{n_steps} steps and {DET_EPOCHS * DET_VAL_IMAGES // batch} eval "
          f"batches")
    check(train["launches"] == want and train["nms"] == 0
          and train["layer_norm"] == [0, 0],
          f"train launches {train}, want {want} and no NMS or LayerNorm")
    for line in open(path("train.log")).read().splitlines():
        if line.startswith(("model ", "peak device")):
            print(f"[det] the run says: {line}")
    run_cli(base + ["-c", path("ck"), "--eval-only"],
            dict(env, SMOKE_BATCH_LOG=path("eval.json")), path("eval.log"),
            f"{DET_CONFIG} --eval-only")
    said = [line for line in open(path("eval.log")).read().splitlines()
            if line.startswith("eval: mAP@.5=")]
    check(len(said) == 1 and "mAP@[.5:.95]=" in said[0]
          and said[0].endswith(f"images={DET_VAL_IMAGES}"),
          f"--eval-only printed {said}")
    evaluated = json.load(open(path("eval.json")))
    n_eval = DET_VAL_IMAGES // batch
    print(f"[det] --eval-only: {said[0]} (score {DET_SCORE_THR}, IoU 0.5, "
          f"100 detections); nms launches {evaluated['nms']} for {n_eval} "
          f"val batches; moments {evaluated['launches']['bn_moments_fwd']}")
    check(evaluated["nms"] == n_eval
          and evaluated["launches"]["bn_moments_fwd"] == 0,
          f"--eval-only launches {evaluated}")
    return (os.path.join(path("ck"), str(n_steps)), ms,
            train["launches"], evaluated["nms"])


def nms_at_eval(torch, dev, model, images, card, score=DET_SCORE_THR,
                tag="[det]", what="--eval-only's inputs"):
    """Phase 9c: NMS at --eval-only's inputs, the class-shifted boxes of
    one val batch through the trained model at `score`: kernel against
    plain version (equal), candidates per image, passes, kernel, plain
    and bound times (phase 11 calls it at infer's inputs). -> the kernels
    line's fields."""
    from deep_vision_tpu_torch.inference import yolo_decode_outputs
    from deep_vision_tpu_torch.ops.cuda.nms import (
        PASS_CANDIDATES,
        greedy_nms,
        nms_plain,
        selection_plan,
    )

    with torch.inference_mode():
        boxes, scores = yolo_decode_outputs(model(images))
        best, cls = scores.max(dim=-1)
    shifted = (boxes + cls.to(boxes.dtype)[..., None] * 2.0).contiguous()
    best = best.contiguous()
    args = (shifted, best, MAX_DET, IOU_THR, score)
    k_out, p_out = greedy_nms(*args), nms_plain(*args)
    check(all(torch.equal(a, b) for a, b in zip(k_out, p_out)),
          f"nms differs from its plain version at {what}")
    ms, passes, chunks = selection_plan(best, k_out[1], score,
                                        PASS_CANDIDATES)
    plain_ms, _ = time_cuda(torch, lambda: nms_plain(*args), runs=10)
    nms_ms, nms_us = time_cuda(torch, lambda: greedy_nms(*args))
    nb, n = best.shape
    bound_ms, bound_by, nbytes, ops, rounds, picks = nms_bound(
        torch, best, k_out[1], score)
    print(f"{tag} nms at {what} (B={nb}, N={n}, D={MAX_DET}, "
          f"score {score}): candidates above the score per image "
          f"{ms}, passes {passes}, 64-candidate chunks {chunks}, keeps "
          f"{picks.tolist()}; equal to the plain version; kernel "
          f"{nms_ms:.4f} ms (host {nms_us:.1f} us), plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} "
          f"ops over the candidates in {rounds} rounds); library: none "
          f"({card})")
    return {"max_abs_err": float((k_out[0] - p_out[0]).abs().max()),
            "ms": nms_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def det_against_cpu(torch, dev):
    """Phase 9d: one float32 yolov3_coco step (yolo_train_loss_fn at the
    416 grids) at DET_CHECK_BATCH on the card (kernels) and on the CPU
    (plain versions) from the same seeded weights and the CLI's fake
    detection batch, TF32 off, the CPU taking the card's leaky-ReLU and
    ignore-mask decisions: the loss, every gradient and every running
    statistic within DET_CHECK_TOL (card_cpu_shares)."""
    import copy
    import dataclasses
    import functools

    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.losses import yolo
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments
    from deep_vision_tpu_torch.train_cli import _fake_detection

    cfg = dataclasses.replace(get_config(DET_CONFIG),
                              batch_size=DET_CHECK_BATCH)
    host = _fake_detection(cfg, 1)[0]
    s = cfg.input_shape[0]
    loss_fn = functools.partial(yolo.yolo_train_loss_fn,
                                grid_sizes=(s // 32, s // 16, s // 8),
                                num_classes=cfg.num_classes)
    cpu = get_model(cfg.model, device="cpu", seed=0, train=True,
                    num_classes=cfg.num_classes)
    card_model = copy.deepcopy(cpu).to(dev)
    best_iou0, taken, flips = yolo.best_iou, [], [0]

    def record(pred, gt, anchors):
        iou = best_iou0(pred, gt, anchors)
        taken.append(iou.cpu())
        return iou

    def replay(pred, gt, anchors):
        iou, card = best_iou0(pred, gt, anchors), taken.pop(0)
        differ = (iou > 0.5) != (card > 0.5)
        check(bool(((iou[differ] - 0.5).abs() <= IOU_MARGIN).all()),
              "an ignore-mask decision differs beyond IOU_MARGIN")
        flips[0] += int(differ.sum())
        return torch.where(differ, card, iou)

    runs, branches = [], BranchReplay(torch)
    try:
        for model, hook in ((card_model, record), (cpu, replay)):
            yolo.best_iou = hook
            where = next(model.parameters()).device
            before = (batch_moments.launches, batch_moments.backward_launches)
            batch = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
            loss, metrics = branches.run(model, lambda: loss_fn(
                model(batch["image"]), batch), replay=model is cpu)
            loss.backward()
            runs.append((
                float(loss.detach()),
                {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()},
                {k: b.detach().cpu() for k, b in model.named_buffers()},
                (batch_moments.launches - before[0],
                 batch_moments.backward_launches - before[1]),
                {k: float(v) for k, v in metrics.items()}))
    finally:
        yolo.best_iou = best_iou0
    (lk, gk, sk, nk, mk), (lp, gp, sp, np_, mp) = runs
    check(nk == (DET_BN, DET_BN) and np_ == (0, 0),
          f"moments launches card {nk}, cpu {np_}")
    check(branches.i == len(branches.taken) == DET_BN and not taken,
          f"replayed {branches.i} of {len(branches.taken)} leaky ReLUs, "
          f"{len(taken)} ignore masks left")
    share, at = card_cpu_shares(lk, lp, (gk, gp), (sk, sp), DET_CHECK_TOL)
    print(f"[det] float32 batch {DET_CHECK_BATCH}, card vs CPU ({DET_BN} "
          f"leaky ReLUs replayed, {flips[0]} ignore decisions within "
          f"{IOU_MARGIN} of the threshold replayed): loss {lk:.6f} vs "
          f"{lp:.6f}; terms card "
          f"{ {k: round(v, 4) for k, v in mk.items()} }; the worst error as "
          f"a share of its tolerance "
          f"{ {k: float(f'{v:.3e}') for k, v in share.items()} } at {at}; "
          f"tolerances {DET_CHECK_TOL}")
    for kind, e in share.items():
        check(e <= 1.0, f"{DET_CONFIG}: card vs CPU {kind} error {e:.3f} of "
              f"its tolerance ({at.get(kind, kind)})")
    del cpu, card_model, runs
    torch.cuda.empty_cache()


def det_phase(torch, dev, card, tmp, env):
    """Phase 9: detection training. Returns the kernels line's entries
    for its path (the moments at YOLOv3's shapes, NMS at score 0.1)."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.train_cli import build_dataloaders

    t0 = time.perf_counter()
    data = det_records(tmp)
    ck, ms, train_launches, nms_launches = det_cli(torch, card, tmp, data,
                                                   env)
    cfg = get_config(DET_CONFIG)
    model = get_model(cfg.model, num_classes=cfg.num_classes, device=dev,
                      train=True)
    model.load_state_dict(torch.load(os.path.join(ck, "state.pt"),
                                     map_location=dev,
                                     weights_only=True)["model"])
    train_fn, eval_fn = build_dataloaders(cfg, data, False, 0, 8)
    images = torch.as_tensor(next(iter(train_fn()))["image"]).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the CLI keeps the default
    try:
        tot = f32_step_kernels(torch, dev, model, images, card,
                               counts=(0, DET_BN), tag="[det]")
        val = torch.as_tensor(next(iter(eval_fn()))["image"]).to(dev)
        nms_row = nms_at_eval(torch, dev, model.eval(), val, card)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del model, images, val
    torch.cuda.empty_cache()
    det_against_cpu(torch, dev)
    entries = [{"name": "nms[yolov3_coco --eval-only, score 0.1]",
                "route": "cuda", "source": "deep_vision_tpu_torch/csrc/nms.cu",
                "replaces": "deep_vision_tpu/ops/pallas/nms.py:42",
                "launches": nms_launches, **nms_row}]
    for name in ("bn_moments_fwd", "bn_moments_bwd"):
        row = tot[name]
        bound_ms, bound_by = bound_of(row["bytes"], row["ops"])
        entries.append({
            "name": f"{name}[yolov3_coco]", "route": "cuda",
            "source": "deep_vision_tpu_torch/csrc/norm.cu",
            "replaces": "deep_vision_tpu/nn/layers.py:129",
            "launches": train_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": row["library_ms"]})
    print(f"[det] {DET_CONFIG} trained through the CLI, evaluated, its "
          f"kernels timed and its step held against the CPU in "
          f"{time.perf_counter() - t0:.1f} s; {ms:.3f} ms/step ({card})")
    return entries


#: phase 10: the GAN, pose and CenterNet configs, and the training
#: BatchNorms a step of each: its moments' forward and backward launches
#: (the reference's variable trees hold as many; CycleGAN's instance
#: norm takes no moments)
GAN_POSE_BN = {"hourglass_mpii": 182, "centernet_coco": 199,
               "dcgan_mnist": 3, "cyclegan": 0}
GAN_POSE_WARMUP, GAN_POSE_STEPS = 2, 5
#: the float32 card-against-CPU steps, ZOO_CHECK_TOL's rules: Hourglass
#: and CenterNet at their registered inputs with batch 1, where their
#: deepest BatchNorms normalise 16 rows a channel (at smaller inputs 1 to
#: 4, and float32 rounding alone moves the gradients through them by
#: percents); DCGAN at batch GAN_CHECK_BATCH with the noise and dropout
#: masks passed in; CycleGAN at CYCLEGAN_CHECK_SIZE, one A and one B
#: image; the CPU takes the card's ReLU, leaky-ReLU and max-pool
#: decisions (BranchReplay)
GAN_POSE_CHECK_TOL = {"loss": 1e-4, "grad": 2e-2, "stats": 1e-3}
GAN_CHECK_BATCH, CYCLEGAN_CHECK_SIZE = 8, 64
#: CycleGAN's biases that a `_Norm` normalises away: zero gradients in
#: exact arithmetic, held against their kernel's largest gradient
CYCLEGAN_NORMED = {"generator": ("Conv_0", "Conv_1", "Conv_2",
                                 "ConvTranspose_0", "ConvTranspose_1"),
                   "discriminator": ("Conv_1", "Conv_2", "Conv_3")}
#: the CLI runs' data: MPII-layout people (images POSE_SIZE x 5/4 of it)
#: and COCO-layout images at CenterNet's 512 through tools/convert.py,
#: CycleGAN's image folders (A and B) through `convert.py cyclegan`
POSE_TRAIN, POSE_VAL, POSE_SIZE, POSE_EPOCHS = 32, 32, 320, 2
CN_TRAIN, CN_VAL = 64, 32
CYC_IMAGES, CYC_VAL, CYC_SIZE = 4, 2, 256
DCGAN_FAKE_BATCHES = 2


def gan_pose_parts(torch, dev, name, batch):
    """(trainer, step fn -> losses, the moments model and its input) for
    `name` at `batch` as train_cli builds it, on its seeded fake batch."""
    import dataclasses

    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.train_cli import (
        FAKE_DATA,
        build_gan_trainer,
        build_trainer,
    )

    cfg = dataclasses.replace(get_config(name), batch_size=batch)
    if name == "cyclegan":  # one A and one B image, the reference's feed
        cfg = dataclasses.replace(cfg, batch_size=2)
    host = FAKE_DATA[cfg.task](cfg, 1)[0]
    placed = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
    if cfg.task in ("pose", "centernet"):
        trainer = build_trainer(cfg, lambda: [host], None, device=dev)
        return (trainer, lambda: [trainer.train_step(placed)["loss"]],
                trainer.model, placed["image"])
    trainer = build_gan_trainer(cfg, device=dev)
    images = placed["image"]
    if name == "dcgan_mnist":
        noise = torch.randn(batch, 100, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        return (trainer, lambda: list(trainer.train_step(images).values()),
                trainer.g_state.model, noise)
    return (trainer, lambda: list(trainer.train_step(
        images[:1], images[1:2]).values()), None, None)


def gan_pose_steps(torch, dev, card):
    """Phase 10a and 10b: each config at its registered width, input,
    batch, float32 and optimizer (CenterNet's batch of 32 fits in the
    H100's 80 GB: 57.5 GiB at its peak), GAN_POSE_WARMUP then GAN_POSE_STEPS
    timed steps under the CLI's precision (cuDNN TF32 on): ms/step,
    images/s, peak memory, finite losses, the moments' launches a step
    against GAN_POSE_BN; then every moments call of a step against its
    plain version (f32_step_kernels) and the kernels a call from a
    profiler trace. -> ({config: (ms, images/s, peak GiB)},
    {config: f32_step_kernels' sums})."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.norm import (
        batch_moments,
        moments_plan,
    )

    out, sums, traced = {}, {}, []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the CLI keeps the default
    try:
        for name, n_bn in GAN_POSE_BN.items():
            batch = get_config(name).batch_size
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            trainer, step, model, images = gan_pose_parts(torch, dev, name,
                                                          batch)
            build_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(GAN_POSE_WARMUP):
                step()
            torch.cuda.synchronize()
            fused_scale_bias_act.launches = 0  # the fixed step's run starts
            fused_scale_bias_act.backward_launches = 0
            batch_moments.launches = 0
            batch_moments.backward_launches = 0
            events, losses = [], []
            for _ in range(GAN_POSE_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(step())
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            launches = zoo_launches(torch, fused_scale_bias_act,
                                    batch_moments)  # ... and ends here
            ms = statistics.median(a.elapsed_time(b) for a, b in events)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            losses = [[float(v) for v in row] for row in losses]
            want = {"bn_act_fwd": 0, "bn_act_bwd": 0,
                    "bn_moments_fwd": n_bn * GAN_POSE_STEPS,
                    "bn_moments_bwd": n_bn * GAN_POSE_STEPS}
            images_a_step = 2 if name == "cyclegan" else batch
            ips = images_a_step / ms * 1e3
            n_params = sum(p.numel() for s in (
                trainer.states().values() if hasattr(trainer, "states")
                else [trainer.state]) for p in s.model.parameters())
            cfg = get_config(name)
            print(f"[gan_pose] {name} ({n_params} parameters, "
                  f"{'x'.join(map(str, cfg.input_shape))}, float32 batch "
                  f"{batch}{' (one A + one B image)' if name == 'cyclegan' else ''}, "
                  f"{cfg.optimizer['name']}): {ms:.3f} ms/step median of "
                  f"{GAN_POSE_STEPS} (CUDA events), {ips:.1f} images/s, peak "
                  f"memory {peak:.2f} GiB (max_memory_allocated over what "
                  f"was held before); losses "
                  f"{[[round(v, 4) for v in row] for row in losses]}; "
                  f"launches {launches} over {GAN_POSE_STEPS} steps; built "
                  f"in {build_s:.1f} s ({card})")
            check(launches == want, f"{name}: launches {launches}, want "
                  f"{want} ({n_bn} training BatchNorms a step)")
            check(all(np.isfinite(row).all() for row in losses),
                  f"{name}: non-finite loss")
            out[name] = (ms, ips, peak)
            if model is not None:
                sums[name] = f32_step_kernels(
                    torch, dev, model, images, card, counts=(0, n_bn),
                    tag=f"[gan_pose] {name}")
                _, moments = batchnorm_calls(torch, model, images)
                for shape in sorted(moments):
                    rows = int(np.prod(shape)) // shape[1]
                    traced.append((torch.empty(shape, device="meta"), None,
                                   None, moments_plan(rows, shape[1], sms, 4),
                                   f"{name} {shape} float32"))
            del trainer, step, model, images
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check_moments_launches(torch, traced, "[gan_pose]")
    return out, sums


def pose_against_cpu(torch, dev, name):
    """Phase 10c for the Trainer configs: one float32 step of `name`'s
    registered model at its input and batch 1 on the card (kernels) and
    on the CPU (plain versions), TF32 off, the CPU taking the card's ReLU
    and max-pool decisions: the loss, every gradient and every running
    statistic within GAN_POSE_CHECK_TOL (card_cpu_shares)."""
    import copy
    import dataclasses

    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.losses import (
        centernet_loss_fn,
        hourglass_loss_fn,
    )
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments
    from deep_vision_tpu_torch.train_cli import FAKE_DATA

    cfg = dataclasses.replace(get_config(name), batch_size=1)
    host = FAKE_DATA[cfg.task](cfg, 1)[0]
    loss_fn = (hourglass_loss_fn if cfg.task == "pose"
               else centernet_loss_fn)
    cpu = get_model(cfg.model, device="cpu", seed=0, train=True,
                    num_classes=cfg.num_classes, **cfg.model_kwargs)
    card_model = copy.deepcopy(cpu).to(dev)
    runs, branches = [], BranchReplay(torch)
    t0 = time.perf_counter()
    for model in (card_model, cpu):
        where = next(model.parameters()).device
        before = (batch_moments.launches, batch_moments.backward_launches)
        batch = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
        loss, _ = branches.run(model, lambda: loss_fn(
            model(batch["image"]), batch), replay=model is cpu)
        loss.backward()
        runs.append((float(loss.detach()),
                     {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters()},
                     {k: b.detach().cpu() for k, b in model.named_buffers()},
                     (batch_moments.launches - before[0],
                      batch_moments.backward_launches - before[1])))
    (lk, gk, sk, nk), (lp, gp, sp, np_) = runs
    n_bn = GAN_POSE_BN[name]
    check(nk == (n_bn, n_bn) and np_ == (0, 0),
          f"{name}: moments launches card {nk}, cpu {np_}")
    check(branches.i == len(branches.taken) > 0,
          f"{name}: replayed {branches.i} of {len(branches.taken)} "
          f"decisions")
    share, at = card_cpu_shares(lk, lp, (gk, gp), (sk, sp),
                                GAN_POSE_CHECK_TOL)
    print(f"[gan_pose] {name} float32 batch 1 at "
          f"{'x'.join(map(str, cfg.input_shape))}, card vs CPU "
          f"({len(branches.taken)} ReLU and max-pool decisions replayed) in "
          f"{time.perf_counter() - t0:.1f} s: loss {lk:.6f} vs {lp:.6f}; "
          f"the worst error as a share of its tolerance "
          f"{ {k: float(f'{v:.3e}') for k, v in share.items()} } at {at}; "
          f"tolerances {GAN_POSE_CHECK_TOL}")
    for kind, e in share.items():
        check(e <= 1.0, f"{name}: card vs CPU {kind} error {e:.3f} of its "
              f"tolerance ({at.get(kind, kind)})")
    del cpu, card_model, runs
    torch.cuda.empty_cache()


def gan_against_cpu(torch, dev, name):
    """Phase 10c for the GANs: one float32 step through the GAN trainer
    on the card and on the CPU from the same seeded weights, TF32 off:
    DCGAN at GAN_CHECK_BATCH with numpy-seeded noise and dropout masks
    passed in, CycleGAN at CYCLEGAN_CHECK_SIZE (G step, pool, D step);
    the CPU takes the card's ReLU and leaky-ReLU decisions. The losses,
    every sub-network's gradients (read where the trainer applies them)
    and DCGAN G's running statistics within GAN_POSE_CHECK_TOL; a
    CycleGAN bias that a `_Norm` normalises away against its kernel's
    largest gradient."""
    import dataclasses

    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.train import gan
    from deep_vision_tpu_torch.train_cli import build_gan_trainer

    cfg = get_config(name)
    rng = np.random.RandomState(0)
    if name == "dcgan_mnist":
        b = GAN_CHECK_BATCH
        real = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
        noise = rng.randn(b, 100).astype(np.float32)
        masks = [[torch.from_numpy(rng.rand(b, c, s, s) < 0.7)
                  for c, s in ((64, 14), (128, 7))] for _ in range(3)]
    else:
        size = CYCLEGAN_CHECK_SIZE
        cfg = dataclasses.replace(cfg, input_shape=(size, size, 3))
        real_a, real_b = (rng.uniform(-1, 1, (1, size, size, 3)).astype(
            np.float32) for _ in range(2))
    apply0, runs, branches = gan._apply, [], BranchReplay(torch)
    t0 = time.perf_counter()
    try:
        for replay, where in ((False, dev), (True, torch.device("cpu"))):
            trainer = build_gan_trainer(cfg, device=where)
            names = {id(s): k for k, s in trainer.states().items()}
            grads = {}

            def record(state, g):
                params = [n for n, _ in state.model.named_parameters()]
                grads[names[id(state)]] = {
                    n: t.detach().cpu() for n, t in zip(params, g)}
                return apply0(state, g)

            gan._apply = record
            if name == "dcgan_mnist":
                metrics = branches.run(
                    trainer.g_state.model, lambda: trainer.train_step(
                        real, noise=noise, dropout_masks=masks),
                    replay=replay)
                stats = {k: v.detach().cpu() for k, v in
                         trainer.g_state.model.named_buffers()}
            else:
                metrics = branches.run(
                    trainer.gab.model, lambda: trainer.train_step(
                        real_a, real_b), replay=replay)
                stats = {}
            runs.append(({k: float(v) for k, v in metrics.items()}, grads,
                         stats))
            del trainer
    finally:
        gan._apply = apply0
    (mk, gk, sk), (mp, gp, sp) = runs
    check(branches.i == len(branches.taken) > 0,
          f"{name}: replayed {branches.i} of {len(branches.taken)} "
          f"decisions")
    tol = GAN_POSE_CHECK_TOL
    share = {"loss": max(abs(mk[k] - mp[k]) / abs(mp[k]) for k in mp)
             / tol["loss"], "grad": 0.0, "stats": 0.0}
    at = {}
    for net, want in gp.items():
        kind = "generator" if net.startswith("g") else "discriminator"
        for k, w in want.items():
            scale = float(w.abs().max())
            layer = k.rsplit(".", 2)[-2] if "." in k else ""
            if (name == "cyclegan" and k.endswith(".bias")
                    and layer in CYCLEGAN_NORMED[kind]):
                scale = float(want[k[:-len("bias")] + "weight"].abs().max())
            e = float((gk[net][k] - w).abs().max()) / (
                tol["grad"] * max(scale, 1e-30))
            if e > share["grad"]:
                share["grad"], at["grad"] = e, f"{net}.{k}"
    if sp:  # DCGAN G's running statistics
        stats_share, stats_at = card_cpu_shares(1.0, 1.0, ({}, {}),
                                                (sk, sp), tol)
        share["stats"] = stats_share["stats"]
        at.update(stats_at)
    print(f"[gan_pose] {name} float32 card vs CPU "
          f"({len(branches.taken)} ReLU decisions replayed) in "
          f"{time.perf_counter() - t0:.1f} s: losses card "
          f"{ {k: round(v, 6) for k, v in mk.items()} }, CPU "
          f"{ {k: round(v, 6) for k, v in mp.items()} }; the worst error "
          f"as a share of its tolerance "
          f"{ {k: float(f'{v:.3e}') for k, v in share.items()} } at {at}; "
          f"tolerances {tol}")
    for kind, e in share.items():
        check(e <= 1.0, f"{name}: card vs CPU {kind} error {e:.3f} of its "
              f"tolerance ({at.get(kind, kind)})")
    torch.cuda.empty_cache()


def gan_pose_records(tmp):
    """The CLI runs' records under `tmp`: seeded MPII-layout people and
    COCO-layout images through `tools/convert.py mpii` / `coco`, and
    CycleGAN image folders through `convert.py cyclegan`. -> {config:
    data dir}."""
    from deep_vision_tpu_torch.tools import convert
    from deep_vision_tpu_torch.tools.synth_records import (
        write_synth_coco,
        write_synth_image_folder,
        write_synth_mpii,
    )

    t0 = time.perf_counter()
    dirs = {k: os.path.join(tmp, f"gp_{k}") for k in
            ("hourglass_mpii", "centernet_coco", "cyclegan")}
    for split, n, seed in (("train", POSE_TRAIN, 0), ("val", POSE_VAL, 1)):
        js, images = write_synth_mpii(os.path.join(tmp, "mpii", split),
                                      split, n, POSE_SIZE, seed=seed)
        check(convert.main(["mpii", "--json", js, "--images-dir", images,
                            "--out-dir", dirs["hourglass_mpii"], "--prefix",
                            split, "--num-shards", "2", "--workers",
                            "1"]) == 0, f"tools/convert.py mpii {split}")
    for split, n, seed in (("train", CN_TRAIN, 0), ("val", CN_VAL, 1)):
        js, images = write_synth_coco(os.path.join(tmp, "cn_coco"), split,
                                      n, 512, seed=seed)
        check(convert.main(["coco", "--instances-json", js, "--images-dir",
                            images, "--out-dir", dirs["centernet_coco"],
                            "--prefix", split, "--num-shards", "2",
                            "--workers", "1"]) == 0,
              f"tools/convert.py coco {split}")
    for i, (folder, n) in enumerate((("trainA", CYC_IMAGES),
                                     ("trainB", CYC_IMAGES),
                                     ("val", CYC_VAL))):
        images = os.path.join(tmp, "cyc_images", folder)
        write_synth_image_folder(images, n, CYC_SIZE, seed=i)
        check(convert.main(["cyclegan", "--images-dir", images, "--out-dir",
                            dirs["cyclegan"], "--prefix", folder,
                            "--workers", "1"]) == 0,
              f"tools/convert.py cyclegan {folder}")
    print(f"[gan_pose] wrote and converted {POSE_TRAIN} + {POSE_VAL} MPII "
          f"people ({POSE_SIZE}x{POSE_SIZE * 5 // 4}), {CN_TRAIN} + {CN_VAL} "
          f"COCO-layout 512x512 images and 2 x {CYC_IMAGES} + {CYC_VAL} "
          f"CycleGAN {CYC_SIZE}x{CYC_SIZE} images in "
          f"{time.perf_counter() - t0:.1f} s")
    return dirs


def gan_pose_cli(torch, card, tmp, env):
    """Phase 10d: the four configs through `train_cli` in subprocesses,
    as a user runs them: hourglass_mpii POSE_EPOCHS epochs on the MPII
    records, then `--eval-only` (its PCK line); centernet_coco one epoch
    on the COCO records, then `--eval-only` (mAP); cyclegan `--batch-size 2` two epochs on the
    image-only records, then `-c` to a third; dcgan_mnist `--fake-data`
    one epoch, then `-c` to a second. The hook counts each run's
    launches. -> {config: the train run's launches}."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.obs.journal import read_journal

    dirs = gan_pose_records(tmp)
    launches = {}

    def path(name):
        return os.path.join(tmp, "gp_" + name)

    def run(name, tag, args):
        log = path(f"{tag}.log")
        run_cli([sys.executable, "-m", "deep_vision_tpu_torch.train_cli",
                 "-m", name, *args],
                dict(env, SMOKE_BATCH_LOG=path(f"{tag}.json")), log,
                f"{name} {tag}")
        for line in open(log).read().splitlines():
            if line.startswith(("model ", "peak device", "resumed",
                                "eval:")):
                print(f"[gan_pose] {name} {tag} says: {line}")
        return (open(log).read().splitlines(),
                json.load(open(path(f"{tag}.json"))))

    for name, epochs, images in (
            ("hourglass_mpii", POSE_EPOCHS, POSE_TRAIN),
            ("centernet_coco", 1, CN_TRAIN)):
        batch = get_config(name).batch_size
        base = ["--data-dir", dirs[name]]
        _, hooked = run(name, "train", base + [
            "--ckpt-dir", path(f"{name}_ck"), "--epochs", str(epochs),
            "--journal", path(f"{name}.jsonl")])
        steps, _ = cli_report(read_journal(path(f"{name}.jsonl")),
                              f"{name} run", card, tag="[gan_pose]",
                              metric="loss")
        n_steps = epochs * (images // batch)
        n_bn = GAN_POSE_BN[name]
        check(len(steps) == n_steps
              and all(np.isfinite(r["loss"]) for r in steps),
              f"{name}: {len(steps)} steps, want {n_steps}, all finite")
        want = {"bn_act_fwd": 0, "bn_act_bwd": 0,
                "bn_moments_fwd": n_bn * n_steps,
                "bn_moments_bwd": n_bn * n_steps}
        check(hooked["launches"] == want, f"{name}: launches "
              f"{hooked['launches']}, want {want}")
        launches[name] = hooked["launches"]
        lines, hooked = run(name, "eval", base + [
            "-c", path(f"{name}_ck"), "--eval-only"])
        said = [line for line in lines if line.startswith("eval: ")]
        val = POSE_VAL if name == "hourglass_mpii" else CN_VAL
        if name == "hourglass_mpii":
            check(len(said) == 1 and said[0].startswith("eval: PCK@0.05="),
                  f"{name} --eval-only printed {said}")
        else:
            check(len(said) == 1 and said[0].startswith("eval: mAP@.5=")
                  and "mAP@[.5:.95]=" in said[0]
                  and said[0].endswith(f"images={val // batch * batch}"),
                  f"{name} --eval-only printed {said}")
        check(hooked["launches"]["bn_moments_fwd"] == 0,
              f"{name} --eval-only took batch moments")
    for name, first, extra in (
            ("cyclegan", ["--data-dir", dirs["cyclegan"], "--batch-size",
                          "2"], 2),
            ("dcgan_mnist", ["--fake-data", "--fake-batches",
                             str(DCGAN_FAKE_BATCHES)], 1)):
        ck, journal = path(f"{name}_ck"), path(f"{name}.jsonl")
        base = first + ["--ckpt-dir", ck, "--journal", journal]
        _, hooked = run(name, "train", base + ["--epochs", str(extra)])
        lines, _ = run(name, "resume", base + ["--epochs", str(extra + 1),
                                                "-c", "auto"])
        check(f"resumed GAN training at epoch {extra}" in lines,
              f"{name}: the resume did not restore epoch {extra}")
        rows = read_journal(journal)
        steps, _ = cli_report(rows, f"{name} runs", card, tag="[gan_pose]",
                              metric="loss")
        per_epoch = (2 * CYC_IMAGES // 2 if name == "cyclegan"
                     else DCGAN_FAKE_BATCHES)
        summaries = [r["summary"] for r in rows if r["event"] == "epoch"]
        check(len(steps) == (extra + 1) * per_epoch
              and len(summaries) == extra + 1
              and all(np.isfinite(list(s.values())).all()
                      for s in summaries),
              f"{name}: {len(steps)} steps, epochs {summaries}")
        n_bn = GAN_POSE_BN[name]
        want = {"bn_act_fwd": 0, "bn_act_bwd": 0,
                "bn_moments_fwd": n_bn * extra * per_epoch,
                "bn_moments_bwd": n_bn * extra * per_epoch}
        check(hooked["launches"] == want, f"{name}: launches "
              f"{hooked['launches']}, want {want}")
        launches[name] = hooked["launches"]
        print(f"[gan_pose] {name}: epoch summaries {summaries}")
    return launches


def gan_pose_phase(torch, dev, card, tmp, env):
    """Phase 10: GAN, pose and CenterNet training. Returns the kernels
    line's entries for its path (the moments at the new shapes)."""
    t0 = time.perf_counter()
    timed, sums = gan_pose_steps(torch, dev, card)
    for name in ("hourglass_mpii", "centernet_coco"):
        pose_against_cpu(torch, dev, name)
    for name in ("dcgan_mnist", "cyclegan"):
        gan_against_cpu(torch, dev, name)
    launches = gan_pose_cli(torch, card, tmp, env)
    entries = []
    for config, tot in sums.items():
        for name in ("bn_moments_fwd", "bn_moments_bwd"):
            row = tot[name]
            bound_ms, bound_by = bound_of(row["bytes"], row["ops"])
            entries.append({
                "name": f"{name}[{config}]", "route": "cuda",
                "source": "deep_vision_tpu_torch/csrc/norm.cu",
                "replaces": "deep_vision_tpu/nn/layers.py:129",
                "launches": launches[config][name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": row["library_ms"]})
    print(f"[gan_pose] {len(timed)} configs stepped at registered width, "
          f"their moments held against plain, each step against the CPU, "
          f"and each trained through the CLI in "
          f"{time.perf_counter() - t0:.1f} s; ms/step "
          f"{ {k: round(v[0], 3) for k, v in timed.items()} } ({card})")
    return entries


#: phase 11: the inference CLI, `deep_vision_tpu_torch.tools.infer.main`
#: in this process, INFER_CALLS calls a family on INFER_IMAGES seeded
#: JPEGs; the kernel launches each call must make: (NMS, bn_act forward,
#: LayerNorm forward). resnet50's eval BatchNorms with ReLU or a residual
#: take bn_act (48 a forward), vit_s16's 25 LayerNorms the LayerNorm
#: kernel (T = 196 takes the dense attention: no flash), yolov3_voc's
#: detector one NMS; the rest launch none of the three
INFER_LAUNCHES = {"resnet50": (0, 48, 0), "vit_s16": (0, 0, 25),
                  "yolov3_voc": (1, 0, 0), "hourglass_mpii": (0, 0, 0),
                  "centernet_coco": (0, 0, 0), "cyclegan": (0, 0, 0),
                  "dcgan_mnist": (0, 0, 0)}
INFER_IMAGES, INFER_CALLS = 2, 3
#: the card against `--device cpu` on the same checkpoint and JPEGs, on
#: the tensors themselves (caught by a forward hook): resnet50's logits
#: and each YOLOv3 head within INFER_RTOL of the tensor's largest
#: magnitude (float32 sums in cuDNN's and the CPU's orders, TF32 off);
#: yolov3_voc's detections matched by class in any order, each score
#: within INFER_DET_TOL and each box corner within INFER_DET_TOL of
#: max(1, the box's width, its height) (float32 on the CPU against
#: float64 there: 1.7e-5 to 3.3e-5); a detection one side kept and the
#: other dropped at an IoU within INFER_IOU_MARGIN of IOU_THR (boxes
#: within INFER_DET_TOL move an IoU by a few 1e-4) is a flip at the
#: threshold's edge, not a fault
INFER_RTOL, INFER_DET_TOL, INFER_IOU_MARGIN = 1e-4, 1e-4, 1e-3
#: the seeded yolov3_voc's head outputs, set per channel over the JPEGs
#: to what a detector shows on a photo of a few large objects: (tx, ty)
#: mean 0, spread 1; (tw, th) mean YOLO_HEAD_WH[level], spread 0.3
#: (boxes 1.6-20x their anchors, 100-600 pixels of 416); objectness mean
#: 0, spread 1; class k mean -k, spread 1 (a few classes lead). Then
#: boxes of a class overlap and NMS suppresses: the 100 keeps come from
#: the best 223 and 319 candidates (seeded init, on the CPU)
YOLO_HEAD_WH = (0.5, 1.5, 3.0)


def infer_jpegs(tmp):
    """INFER_IMAGES seeded 480x640 JPEGs: a smooth colour gradient with
    seeded noise and a bright rectangle, so the decoders and resizes see
    edges and texture."""
    from deep_vision_tpu_torch.tools.synth_records import encode_jpeg

    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    paths = []
    for i in range(INFER_IMAGES):
        img = np.stack([xx / 640 * 255, yy / 480 * 255,
                        np.full_like(xx, 80 + 60 * i)], -1)
        img += rng.randn(480, 640, 3) * 20
        y0, x0 = rng.randint(0, 300), rng.randint(0, 400)
        img[y0:y0 + 150, x0:x0 + 200] = 230
        path = os.path.join(tmp, f"infer_{i}.jpg")
        with open(path, "wb") as f:
            f.write(encode_jpeg(np.clip(img, 0, 255).astype(np.uint8)))
        paths.append(path)
    return paths


def standardise_yolo_heads(torch, model, images):
    """Rescale each YOLOv3 head's last 1x1 conv so that its outputs on
    `images` take the per-channel means and spreads YOLO_HEAD_WH's
    comment gives."""
    heads = [getattr(model, f"YoloHead_{i}") for i in range(3)]
    seen = {}
    hooks = [h.Conv_0.register_forward_hook(
        lambda m, i, o, k=k: seen.__setitem__(k, o.double()))
        for k, h in enumerate(heads)]
    with torch.no_grad():
        model.eval()(images)
        for h in hooks:
            h.remove()
        for k, head in enumerate(heads):
            out, c = seen[k], head.num_classes
            mean, std = out.mean((0, 2, 3)), out.std((0, 2, 3))
            want_mean, want_std = (torch.tensor(
                v * head.num_anchors, dtype=torch.float64,
                device=out.device) for v in (
                [0.0, 0.0, YOLO_HEAD_WH[k], YOLO_HEAD_WH[k], 0.0]
                + [-float(j) for j in range(c)],
                [1.0, 1.0, 0.3, 0.3, 1.0] + [1.0] * c))
            scale = want_std / std
            conv = head.Conv_0
            conv.weight.mul_(scale.view(-1, 1, 1, 1).float())
            conv.bias.copy_(((conv.bias.double() - mean) * scale
                             + want_mean).float())


def run_infer(torch, argv):
    """One `infer.main(argv)` in this process, its kernel counters set to
    0 just before it and read just after. -> (stdout lines, seconds,
    launches)."""
    from deep_vision_tpu_torch.ops.cuda.bn_act import fused_scale_bias_act
    from deep_vision_tpu_torch.ops.cuda.flash_attention import (
        flash_attention,
    )
    from deep_vision_tpu_torch.ops.cuda.nms import greedy_nms
    from deep_vision_tpu_torch.ops.cuda.norm import batch_moments, layer_norm
    from deep_vision_tpu_torch.tools import infer

    counters = ((greedy_nms, "launches", "nms"),
                (fused_scale_bias_act, "launches", "bn_act_fwd"),
                (layer_norm, "launches", "layer_norm_fwd"),
                (fused_scale_bias_act, "backward_launches", "bn_act_bwd"),
                (layer_norm, "backward_launches", "layer_norm_bwd"),
                (flash_attention, "launches", "flash_fwd"),
                (batch_moments, "launches", "bn_moments_fwd"))
    for fn, attr, _ in counters:
        setattr(fn, attr, 0)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = infer.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"infer {argv} returned {rc}")
    return (out.getvalue().splitlines(), seconds,
            {name: getattr(fn, attr) for fn, attr, name in counters})


def run_infer_caught(torch, argv):
    """run_infer with the model's outputs caught by a forward hook and
    the YOLO detector's results by a wrapper, both copied to the host in
    float64. -> (stdout lines, launches, [model outputs], [detections])."""
    import deep_vision_tpu_torch.inference as inference
    import deep_vision_tpu_torch.models as models

    outputs, detections = [], []
    get_model, make = models.get_model, inference.make_yolo_detector

    def host(t):
        return t.detach().double().cpu().numpy()

    def hooked(*args, **kwargs):
        model = get_model(*args, **kwargs)
        model.register_forward_hook(lambda m, i, o: outputs.append(
            [host(t) for t in (o if isinstance(o, tuple) else (o,))]))
        return model

    def detector(*args, **kwargs):
        detect = make(*args, **kwargs)

        def call(variables, images):
            out = detect(variables, images)
            detections.append({k: host(v) for k, v in out.items()})
            return out

        return call

    models.get_model, inference.make_yolo_detector = hooked, detector
    try:
        lines, _, launches = run_infer(torch, argv)
    finally:
        models.get_model, inference.make_yolo_detector = get_model, make
    return lines, launches, outputs, detections


def outputs_alike(got, want, label):
    """Each tensor of `got` within INFER_RTOL x the largest |value| of
    its `want`. -> the worst share of that tolerance."""
    check(len(got) == len(want) and all(g.shape == w.shape
                                        for g, w in zip(got, want)),
          f"{label}: shapes {[g.shape for g in got]} | "
          f"{[w.shape for w in want]}")
    share = max(float(np.abs(g - w).max() / (INFER_RTOL * np.abs(w).max()))
                for g, w in zip(got, want))
    check(share <= 1.0, f"{label}: {share:.3g} of the tolerance")
    return share


def detections_alike(torch, card, cpu, label):
    """yolov3_voc's detections on the card against the CPU's, image by
    image: the same count; each detection matched to one of the other
    side's of its class with score and box within INFER_DET_TOL (the box
    against its extent), in any order (two scores closer than that may
    swap places). One left unmatched must have been dropped by the other
    side at a threshold's edge: a kept box there of its class and at
    least its score overlaps it at an IoU within INFER_IOU_MARGIN of
    IOU_THR (float32 sums in other orders put it on the other side of
    the threshold), or beyond IOU_THR - INFER_IOU_MARGIN where that box
    is itself unmatched (a suppression that follows from such a flip),
    or its score ties the other side's lowest kept score within
    INFER_DET_TOL (the last pick at max_detections). -> (the worst share
    of the tolerance among the matched, {reason: the count left
    unmatched})."""
    from deep_vision_tpu_torch.ops.boxes import broadcast_iou

    worst, loose = 0.0, {"at an IoU edge": 0, "the last pick": 0}
    for i, n in enumerate(card["num"].astype(int)):
        check(n == int(cpu["num"][i]), f"{label}: image {i}: {n} "
              f"detections on the card, {int(cpu['num'][i])} on the CPU")
        dets = {side: [(int(d["classes"][i, j]), d["scores"][i, j],
                        d["boxes"][i, j]) for j in range(n)]
                for side, d in (("card", card), ("CPU", cpu))}
        matched = {"card": [False] * n, "CPU": [False] * n}
        for a, (cls, score, box) in enumerate(dets["card"]):
            shares = [max(abs(score - s), float(np.abs(box - b).max()) / max(
                1.0, b[2] - b[0], b[3] - b[1])) / INFER_DET_TOL
                if c == cls and not matched["CPU"][j] else np.inf
                for j, (c, s, b) in enumerate(dets["CPU"])]
            j = int(np.argmin(shares)) if shares else -1
            if j >= 0 and shares[j] <= 1.0:
                matched["card"][a] = matched["CPU"][j] = True
                worst = max(worst, shares[j])
        iou = broadcast_iou(*(torch.from_numpy(d["boxes"][i, :n])
                              for d in (card, cpu))).numpy()
        for side, other, table in (("card", "CPU", iou),
                                   ("CPU", "card", iou.T)):
            low = min(s for _, s, _ in dets[other]) if n else 0.0
            for a, (cls, score, box) in enumerate(dets[side]):
                if matched[side][a]:
                    continue
                ious = [(table[a, k], matched[other][k])
                        for k, (c, s, _) in enumerate(dets[other])
                        if c == cls and s >= score - INFER_DET_TOL]
                edge = any(abs(iou - IOU_THR) <= INFER_IOU_MARGIN
                           or (iou > IOU_THR - INFER_IOU_MARGIN and not m)
                           for iou, m in ious)
                check(edge or score <= low + INFER_DET_TOL,
                      f"{label}: image {i}: the {side}'s class "
                      f"{cls} at score {score:.6f}, box {box}, has no "
                      f"match; IoUs with the {other}'s kept boxes of its "
                      f"class at a higher score {ious}")
                loose["at an IoU edge" if edge else "the last pick"] += 1
    return worst, loose


def check_infer_output(name, lines, jpegs, out_dir):
    """The family's printed results and files: a top-5 line an image
    (finite probabilities); a count line, its lines and a sidecar (and
    an overlay) an image; 16 finite joints and an overlay an image; a
    decodable generated JPEG an image."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.data.datasets import decode_image

    task = get_config(name).task
    stems = [os.path.splitext(os.path.basename(f))[0] for f in jpegs]
    lines = [line for line in lines if not line.startswith("warning: ")]
    numbers = [[float(v) for v in re.findall(r"-?\d+\.\d+", line)]
               for line in lines]
    check(all(np.isfinite(v).all() for v in numbers),
          f"{name}: non-finite output {lines}")
    if task == "classification":
        check([line.split(": ")[0] for line in lines] == jpegs
              and all(len(v) == 5 for v in numbers), f"{name}: {lines}")
    elif task in ("detection", "centernet"):
        for f, stem in zip(jpegs, stems):
            head = [line for line in lines if line.startswith(f"{f}: ")]
            check(len(head) == 1 and head[0].endswith(" detections"),
                  f"{name}: {lines}")
            n = int(head[0].split(": ")[1].split()[0])
            side = open(os.path.join(out_dir, f"{stem}_boxes.txt")).read()
            check(len([s for s in side.splitlines() if s]) == n,
                  f"{name}: {stem}_boxes.txt has not {n} lines")
            check(os.path.exists(os.path.join(out_dir,
                                              f"{stem}_detected.jpg")),
                  f"{name}: no {stem}_detected.jpg")
    elif task == "pose":
        check(sum(line.startswith("  joint ") for line in lines)
              == 16 * len(jpegs), f"{name}: {lines}")
        for stem in stems:
            check(os.path.exists(os.path.join(out_dir, f"{stem}_pose.jpg")),
                  f"{name}: no {stem}_pose.jpg")
    else:
        for stem in stems:
            with open(os.path.join(out_dir, f"{stem}_generated.jpg"),
                      "rb") as f:
                shape = decode_image(f.read()).shape
            size = get_config(name).input_shape[0]
            check(shape == (size, size, 3), f"{name}: generated {shape}")


def infer_against_cpu(torch, name, argv, tmp):
    """`infer.main` once more on the card and once with `--device cpu`,
    their model outputs (and yolov3_voc's detections) caught and held
    against each other (the timed calls' printed lines are checked for
    their format only)."""
    card_argv = argv + ["-o", os.path.join(tmp, f"infer_hooked_{name}")]
    cpu_argv = argv + ["-o", os.path.join(tmp, f"infer_cpu_{name}"),
                       "--device", "cpu"]
    _, _, out_card, det_card = run_infer_caught(torch, card_argv)
    t0 = time.perf_counter()
    _, got, out_cpu, det_cpu = run_infer_caught(torch, cpu_argv)
    cpu_s = time.perf_counter() - t0
    check(not any(got.values()), f"--device cpu launched {got}")
    check(len(out_card) == len(out_cpu) == 1,
          f"{name}: {len(out_card)} and {len(out_cpu)} forwards caught")
    share = outputs_alike(out_card[0], out_cpu[0], f"{name} card vs CPU")
    said = (f"{name}: the card's model outputs "
            f"{[o.shape for o in out_card[0]]} equal the CPU's within "
            f"{share:.3g} of {INFER_RTOL} x each tensor's largest |value|")
    if det_card:
        worst, loose = detections_alike(torch, det_card[0], det_cpu[0],
                                        f"{name} card vs CPU")
        said += (f"; detections {det_card[0]['num'].astype(int).tolist()} "
                 f"an image matched within {worst:.3g} of {INFER_DET_TOL}; "
                 f"unmatched {loose}")
    print(f"[infer] {said} (the CPU call {cpu_s:.2f} s)")


def infer_phase(torch, dev, card, tmp, ckpts):
    """Phase 11: the inference CLI as a user runs it, each family
    INFER_CALLS times on the card (`ckpts`: config -> a checkpoint dir
    for -c), resnet50 and yolov3_voc once more on the card and with
    --device cpu, and the path's kernels at its shapes. Returns the
    kernels line's entries."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
    from deep_vision_tpu_torch.data.transforms import space_to_depth
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.nn.layers import calibrate_batch_stats
    from deep_vision_tpu_torch.tools import infer

    t_phase = time.perf_counter()
    jpegs = infer_jpegs(tmp)
    # yolov3_voc: the seeded weights with every BatchNorm's running
    # statistics calibrated on these images (init statistics let the
    # residual adds saturate every score) and its heads set so that
    # NMS suppresses (YOLO_HEAD_WH), saved for -c
    yolo = get_model("yolov3", num_classes=20, device=dev)
    x_yolo = torch.as_tensor(np.stack([infer._load_image(f, 416, "unit")
                                       for f in jpegs]), device=dev)
    calibrate_batch_stats(yolo, x_yolo)
    standardise_yolo_heads(torch, yolo, x_yolo)
    ckpts = dict(ckpts, yolov3_voc=os.path.join(tmp, "infer_yolov3_ck"))
    mgr = CheckpointManager(ckpts["yolov3_voc"])
    mgr.save_tree(0, {"model": yolo.state_dict()})
    mgr.close()
    launches = {}
    for name, (n_nms, n_bn, n_ln) in INFER_LAUNCHES.items():
        out_dir = os.path.join(tmp, f"infer_{name}")
        argv = ["-m", name, "-o", out_dir, *jpegs]
        if name in ckpts:
            argv[2:2] = ["-c", ckpts[name]]
        want = {"nms": n_nms, "bn_act_fwd": n_bn, "layer_norm_fwd": n_ln,
                "bn_act_bwd": 0, "layer_norm_bwd": 0, "flash_fwd": 0,
                "bn_moments_fwd": 0}
        seconds, printed, total = [], [], {}
        for _ in range(INFER_CALLS):
            lines, dt, got = run_infer(torch, argv)
            check(got == want, f"infer -m {name}: launches {got}, want "
                  f"{want}")
            check(not printed or lines == printed,
                  f"infer -m {name}: a call printed other results than "
                  f"the first")
            printed = lines
            seconds.append(dt)
            total = {k: total.get(k, 0) + v for k, v in got.items()}
        launches[name] = total
        check_infer_output(name, printed, jpegs, out_dir)
        restored = (f"-c {os.path.relpath(ckpts[name], tmp)}"
                    if name in ckpts else "seeded init")
        steady = statistics.median(seconds[1:])
        print(f"[infer] {name} ({restored}): {INFER_IMAGES} images a call;"
              f" first call {1e3 * seconds[0] / INFER_IMAGES:.1f} ms/image,"
              f" steady {1e3 * steady / INFER_IMAGES:.1f}"
              f" ms/image (median of {INFER_CALLS - 1} calls; wall time of "
              f"main: model build, restore, decode, forward, output; each "
              f"call printed the same); launches a call nms {n_nms}, bn_act "
              f"{n_bn}, layer_norm {n_ln} ({card})")
        for line in printed[:3]:
            print(f"[infer] {name} says: {line}")
    for name in ("resnet50", "yolov3_voc"):
        infer_against_cpu(torch, name, ["-m", name, "-c", ckpts[name],
                                        *jpegs], tmp)
    # the path's kernels at its shapes
    resnet = get_model("resnet50", num_classes=1000, stem="s2d", device=dev)
    resnet.load_state_dict(CheckpointManager(ckpts["resnet50"])
                           .restore_variables(device=dev))
    cfg = get_config("resnet50")
    x_res = torch.as_tensor(np.stack([space_to_depth(infer._load_image(
        f, cfg.eval_crop, "imagenet", rescale=cfg.train_resize))
        for f in jpegs]), device=dev)
    calls, _ = batchnorm_calls(torch, resnet, x_res)
    check(sum(calls.values()) == INFER_LAUNCHES["resnet50"][1],
          f"resnet50's eval forward makes {calls} bn_act calls")
    gen = torch.Generator(device=dev).manual_seed(12)
    bn_row = dict(calls=0, ms=0.0, plain_ms=0.0, bytes=0, ops=0)
    for (shape, res), n in sorted(calls.items()):
        x = torch.randn(shape, generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)
        r = torch.randn_like(x) if res else None
        a = torch.rand(shape[1], generator=gen, device=dev) + 0.5
        b = torch.randn(shape[1], generator=gen, device=dev)
        case = bn_act_fwd_case(torch, x, a, b, r, "[infer]")[1:]
        for key, v in zip(("calls", "ms", "plain_ms", "bytes", "ops"),
                          (1, *case)):
            bn_row[key] += n * v
    bound_ms, bound_by = bound_of(bn_row["bytes"], bn_row["ops"])
    print(f"[infer] bn_act_fwd over one forward's {bn_row['calls']} calls "
          f"at {len(calls)} shapes: equal to the plain version; kernel "
          f"{bn_row['ms']:.4f} ms, plain {bn_row['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / bn_row['ms']:.1f}% of the bound; library none "
          f"({card})")
    bn_row = {"replaces": "deep_vision_tpu/ops/pallas/bn_act.py:78",
              "max_abs_err": 0.0, "ms": bn_row["ms"],
              "plain_ms": bn_row["plain_ms"], "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None}
    ln_row = layer_norm_cases(torch, dev, card, cases=[
        ((INFER_IMAGES, 196, 384), torch.float32, torch.float32, "normal",
         INFER_LAUNCHES["vit_s16"][2])], tag="[infer]")["layer_norm_fwd"]
    nms_row = nms_at_eval(torch, dev, yolo, x_yolo, card, score=0.3,
                          tag="[infer]", what="infer -m yolov3_voc's inputs")
    del yolo, resnet, x_yolo, x_res
    torch.cuda.empty_cache()
    nms_row["replaces"] = "deep_vision_tpu/ops/pallas/nms.py:42"
    entries = [{"name": f"{kernel}[infer -m {config}]", "route": "cuda",
                "source": f"deep_vision_tpu_torch/csrc/{source}",
                "launches": launches[config][kernel], **row}
               for kernel, source, row, config in (
                   ("bn_act_fwd", "bn_act.cu", bn_row, "resnet50"),
                   ("layer_norm_fwd", "norm.cu", ln_row, "vit_s16"),
                   ("nms", "nms.cu", nms_row, "yolov3_voc"))]
    print(f"[infer] {len(INFER_LAUNCHES)} families through infer.main, "
          f"resnet50 and yolov3_voc against --device cpu, the path's "
          f"kernels at its shapes in {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    return entries


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, ROOT)
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
    t_run = time.perf_counter()

    def elapsed(what):
        print(f"[time] {what} {time.perf_counter() - t_run:.1f} s into the "
              f"run", flush=True)

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
    norm_rows = moments_cases(torch, dev, moment_calls, card,
                              yolov3_moment_shapes(torch, dev))
    torch.cuda.empty_cache()
    norm_rows.update(layer_norm_cases(torch, dev, card))
    torch.cuda.empty_cache()
    flash_rows = flash_cases(torch, dev, card)
    elapsed("phases 1-3 (setup, build, kernels) done")

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
    serve_tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    journal, sanitizer, tracer, recorder = serve_black_box(serve_tmp)
    engine = Engine()
    engine.register("yolov3", yolo_predict_fn(model, **det),
                    model.state_dict(), input_shape=(IMAGE, IMAGE, 3),
                    buckets=BUCKETS)
    warm = engine.warmup()
    print(f"[serve] warmup {warm['pairs']} buckets in "
          f"{warm['warmup_ms_total']:.1f} ms")
    server = Server(engine, journal=journal, max_wait_ms=5.0).start()

    requests = [rng.rand(IMAGE, IMAGE, 3).astype(np.float32)
                for _ in range(max(BURSTS))]
    greedy_nms.launches = 0  # the serving path's run starts here
    fused_scale_bias_act.launches = 0
    fused_scale_bias_act.backward_launches = 0
    flash_attention.launches = 0
    batch_moments.launches = 0
    layer_norm.launches = 0
    rows, stream_s, submit_us = serve_stream(server, requests)
    launches = greedy_nms.launches  # ... and ends here
    check(fused_scale_bias_act.launches == 0, "YOLOv3 serving ran bn_act")
    check(flash_attention.launches == 0, "YOLOv3 serving ran flash")
    check(batch_moments.launches == layer_norm.launches == 0,
          "YOLOv3 serving took batch moments or ran a LayerNorm")
    # the drain joins the dispatchers: a batch's SLO count, journal row
    # and span land after its requests resolve, so they are read after it
    summary = server.close()
    print(f"[serve] drain: {summary}")
    check(summary["outcome"] == "flushed", "drain did not flush")
    check(summary["accepted"] == summary["completed"] + summary["errors"]
          + summary["cancelled"] and summary["completed"] == len(rows),
          "drain ledger does not balance")
    check("flight_bundle" not in summary, "a clean close dumped a bundle")
    slo = server.slo.report()["yolov3"]
    print(f"[serve] {len(rows)} requests in {len(BURSTS)} bursts, "
          f"{slo['batches']} batches, {stream_s:.3f} s, {submit_us:.1f} us "
          f"a submit (host clock); nms launches {launches}")
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

    serve_stream_checks(journal, sanitizer, tracer, launches,
                        slo["batches"], card)
    serve_sigterm_drain(torch, engine, journal, recorder, requests, card)
    close_serve_black_box(journal, sanitizer, tracer, recorder)
    shutil.rmtree(serve_tmp)
    bare_stream(engine, requests, (slo["batches"], stream_s, submit_us),
                card)

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
    bound_ms, bound_by, nbytes, ops, rounds, picks = nms_bound(
        torch, best, k_out[1], SCORE_THR)
    print(f"[kernels] nms at serving inputs (B={nb}, N={n}, D={MAX_DET}): "
          f"kernel {nms_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({nbytes} B, {ops} ops, {rounds} "
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
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    del engine, model, x, variables
    torch.cuda.empty_cache()

    elapsed("phase 4 (serve) done")

    # -- 5. training ---------------------------------------------------------
    launches, step_ms, wall_ms = train_phase(torch, trainer, train_batch,
                                             card)
    step_tmp = tempfile.mkdtemp(dir=build.BUILD_DIR)
    traced_step_times(torch, trainer, train_batch, card, step_tmp)
    shutil.rmtree(step_tmp)
    del trainer, train_batch
    torch.cuda.empty_cache()
    check_against_cpu(torch, dev)

    # -- 5b. feed ------------------------------------------------------------
    elapsed("phase 5 (train) done")
    feed_phase(torch, dev, (step_ms, wall_ms), card)
    elapsed("phase 5b (feed) done")
    torch.cuda.empty_cache()
    vit_launches = vit_phase(torch, dev, card)
    check_vit_dense_route(torch, dev)
    torch.cuda.empty_cache()
    check_vit_against_cpu(torch, dev)

    # -- 6. the training CLI, 7. the classifier zoo ---------------------------
    torch.cuda.empty_cache()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        data, env, det = cli_records(tmp)
        elapsed("phase 5 (ViT) and the CLI's records done")
        cli_phase(torch, dev, card, tmp, data, env, det)
        elapsed("phase 6 (cli) done")
        torch.cuda.empty_cache()
        zoo_phase(torch, dev, card, tmp, data, env, det)
        elapsed("phase 7 (zoo) done")
        torch.cuda.empty_cache()
        # -- 8. V-MoE, 9. detection training ---------------------------
        vmoe_launches, vmoe_rows = vmoe_phase(torch, dev, card)
        det_entries = det_phase(torch, dev, card, tmp, env)
        elapsed("phases 8-9 (vmoe, det) done")
        torch.cuda.empty_cache()
        # -- 10. GAN, pose and CenterNet training ----------------------
        gan_pose_entries = gan_pose_phase(torch, dev, card, tmp, env)
        elapsed("phase 10 (gan_pose) done")
        torch.cuda.empty_cache()
        # -- 11. the inference CLI on the checkpoints of phases 6 and 10 -
        infer_entries = infer_phase(torch, dev, card, tmp, {
            "resnet50": os.path.join(tmp, "ck_t"),
            "hourglass_mpii": os.path.join(tmp, "gp_hourglass_mpii_ck"),
            "centernet_coco": os.path.join(tmp, "gp_centernet_coco_ck")})
        elapsed("phase 11 (infer) done")
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

    for name in ("layer_norm_fwd", "layer_norm_bwd"):
        kernels.append({"name": f"{name}[vmoe_s16]", "route": "cuda",
                        "source": "deep_vision_tpu_torch/csrc/norm.cu",
                        "launches": vmoe_launches[name], **vmoe_rows[name]})
    kernels += det_entries + gan_pose_entries + infer_entries

    # -- 12. report ----------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
