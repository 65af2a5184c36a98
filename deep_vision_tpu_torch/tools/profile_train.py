"""The training steps chip_smoke.py drives, and where their time goes on
the card.

    python -m deep_vision_tpu_torch.tools.profile_train [--model resnet50|vit_s16]

`make_train_parts` is the port of bench.py:432-498: ResNet-50 with the
space-to-depth stem, 1000 classes, bf16 convolutions, softmax cross
entropy, SGD (lr 0.1, momentum 0.9, weight decay 1e-4 under the
BatchNorm/bias mask), batch 128 per chip at 224x224, from the
reference's seeds.

`make_vit_train_parts` is ViT-S/16 at 512x512 (T = 1024 tokens, so
attention runs the flash kernels): bf16 activations over f32
parameters, as tools/convergence_run.py:99 builds the model; batch 64
per chip; the registered `vit_s16` recipe (configs/__init__.py:234-244)
as train_cli.py:364-372 builds it: AdamW lr 1e-3, weight decay 1e-4 on
every parameter (decay_bn_bias=True), warmup + cosine to 0, with the
horizon cut to chip_smoke's 13 steps (warmup 3); softmax cross entropy
on one fixed `RandomState(0)` batch.

Run as a module (one CUDA card), it takes 3 warm-up steps, times 5
steps without the profiler, each ending in a synchronise, then profiles
5 more with torch.profiler and prints, per step: the wall time, the
device-busy time (the sum of kernel times, which do not overlap on one
stream), the busy share of the unprofiled wall time, kernel time by
group and the top kernels.
ResNet-50 groups: `conv` (convolution and matmul kernels, forward and
backward), `bn_act_fwd` and `bn_act_bwd` (csrc/bn_act.cu), `bn_stats`
(every kernel launched inside a BatchNorm's batch-statistics range, and
the backward of those operations, matched by autograd sequence number),
`optimizer` (the update) and `other`.
ViT groups: `flash_fwd`, `flash_dq`, `flash_dkv`
(csrc/flash_attention.cu), `matmul` (cuBLAS products and the patch
convolution, forward and backward), `layernorm` (kernels inside a
LayerNorm's range and their backward), `optimizer` and `other`.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.nn.layers import BN_STATS_RANGE, LAYERNORM_RANGE
from deep_vision_tpu_torch.train import Trainer, build_optimizer
from deep_vision_tpu_torch.train.optimizers import make_schedule

BATCH_PER_CHIP = 128
IMAGE_SIZE = 224
NUM_CLASSES = 1000
VIT_BATCH_PER_CHIP = 64
VIT_IMAGE_SIZE = 512
#: the ViT schedule's horizon: chip_smoke's 3 warm-up and 10 timed steps
#: (the recipe's is 5 of 90 epochs), so the loss can be seen to fall
VIT_WARMUP_STEPS, VIT_TOTAL_STEPS = 3, 13
CONV_MARKERS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "winograd",
                "implicit", "sm90", "wgrad", "dgrad", "nvjet")
BN_ACT_KERNELS = {"bn_act_fwd": ("fwd_rows", "fwd_planes"),
                  "bn_act_bwd": ("bwd_rows", "bwd_planes", "reduce_partials")}
FLASH_KERNELS = {"flash_fwd": ("flash_fwd",), "flash_dq": ("flash_dq",),
                 "flash_dkv": ("flash_dkv",)}
GROUPS = ("conv", "bn_act_fwd", "bn_act_bwd", "bn_stats", "optimizer",
          "other")
VIT_GROUPS = ("flash_fwd", "flash_dq", "flash_dkv", "matmul", "layernorm",
              "optimizer", "other")


class Grouping(NamedTuple):
    """How kernels are attributed: by kernel name (`named`, group ->
    markers), by an enclosing profiler range and the backward of what ran
    in it (`ranged`, range name -> group), to `optimizer` inside
    Optimizer.step, to `product` when named like a convolution or a
    matmul, else to `other`."""

    named: Dict[str, Tuple[str, ...]]
    ranged: Dict[str, str]
    product: str
    groups: Tuple[str, ...]


RESNET_GROUPING = Grouping(BN_ACT_KERNELS, {BN_STATS_RANGE: "bn_stats"},
                           "conv", GROUPS)
VIT_GROUPING = Grouping(FLASH_KERNELS, {LAYERNORM_RANGE: "layernorm"},
                        "matmul", VIT_GROUPS)
STEPS = 5


def input_shape(stem: str) -> Tuple[int, ...]:
    """One image's NHWC shape for `stem` at IMAGE_SIZE: s2d (H/2, W/2,
    12), else (H, W, 3)."""
    if stem == "s2d":
        return (IMAGE_SIZE // 2, IMAGE_SIZE // 2, 12)
    return (IMAGE_SIZE, IMAGE_SIZE, 3)


def make_train_parts(batch_per_chip: int = BATCH_PER_CHIP, stem: str = "s2d",
                     device: DeviceLike = None,
                     dtype: torch.dtype = torch.bfloat16):
    """(trainer, batch): a Trainer over the seeded flagship model and one
    batch on its device. The batch is the reference's: `RandomState(0)`
    `rand` images cast to the compute dtype (bf16), then
    `randint(0, 1000)` labels. `dtype` exists for the float32 check
    against the plain path at a small batch."""
    dev = resolve_device(device)
    model = get_model("resnet50", num_classes=NUM_CLASSES, dtype=dtype,
                      stem=stem, device=dev, seed=0, train=True)
    tx = build_optimizer("sgd", learning_rate=0.1, momentum=0.9,
                         weight_decay=1e-4)
    shape = input_shape(stem)
    sample = torch.ones((1, *shape), dtype=torch.float32)
    trainer = Trainer(model, tx, classification_loss_fn, sample, device=dev)
    rng = np.random.RandomState(0)
    images = rng.rand(batch_per_chip, *shape).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, size=(batch_per_chip,))
    batch = {
        "image": torch.from_numpy(images).to(dtype).to(dev),
        "label": torch.from_numpy(labels.astype(np.int32)).to(dev),
    }
    return trainer, batch


def make_vit_train_parts(batch_per_chip: int = VIT_BATCH_PER_CHIP,
                         image_size: int = VIT_IMAGE_SIZE,
                         device: DeviceLike = None,
                         dtype: torch.dtype = torch.bfloat16):
    """(trainer, batch): a Trainer over the seeded ViT-S/16 at
    `image_size` and one batch on its device: `RandomState(0)` `rand`
    images cast to `dtype`, then `randint(0, 1000)` labels. `dtype` is
    the blocks' compute dtype; float32 exists for the card-vs-CPU check."""
    dev = resolve_device(device)
    model = get_model("vit_s16", num_classes=NUM_CLASSES, dtype=dtype,
                      image_size=image_size, device=dev, seed=0, train=True)
    schedule = make_schedule("cosine", 1e-3, warmup_steps=VIT_WARMUP_STEPS,
                             total_steps=VIT_TOTAL_STEPS)
    tx = build_optimizer("adamw", schedule, weight_decay=1e-4,
                         decay_bn_bias=True)
    sample = torch.ones((1, image_size, image_size, 3), dtype=torch.float32)
    trainer = Trainer(model, tx, classification_loss_fn, sample, device=dev)
    rng = np.random.RandomState(0)
    images = rng.rand(batch_per_chip, image_size, image_size, 3).astype(
        np.float32)
    labels = rng.randint(0, NUM_CLASSES, size=(batch_per_chip,))
    batch = {
        "image": torch.from_numpy(images).to(dtype).to(dev),
        "label": torch.from_numpy(labels.astype(np.int32)).to(dev),
    }
    return trainer, batch


def _ancestors(evt):
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def _range_of(evt, ranged) -> Optional[str]:
    for a in _ancestors(evt):
        if a.name in ranged:
            return ranged[a.name]
    return None


def kernel_groups(events: Iterable,
                  grouping: Grouping = RESNET_GROUPING) -> Dict[str, float]:
    """Device microseconds by group over the profiler's `events()`."""
    events = list(events)
    seq = {}  # autograd sequence number -> group of a ranged forward op
    for e in events:
        if e.sequence_nr >= 0:
            g = _range_of(e, grouping.ranged)
            if g is not None:
                seq[e.sequence_nr] = g
    out = {g: 0.0 for g in grouping.groups}
    for e in events:
        for k in e.kernels:
            out[_group(k.name, e, seq, grouping)] += k.duration
    return out


def _group(name: str, evt, seq, grouping: Grouping) -> str:
    for g, markers in grouping.named.items():
        if any(m in name for m in markers):
            return g
    for a in _ancestors(evt):
        if a.name in grouping.ranged:
            return grouping.ranged[a.name]
        if (a.name.startswith("autograd::engine::evaluate_function")
                and a.sequence_nr in seq):
            return seq[a.sequence_nr]
        if a.name.startswith("Optimizer.step"):
            return "optimizer"
    low = name.lower()
    if any(m in low for m in CONV_MARKERS):
        return grouping.product
    return "other"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("resnet50", "vit_s16"),
                        default="resnet50")
    args = parser.parse_args()
    if args.model == "vit_s16":
        trainer, batch = make_vit_train_parts()
        grouping = VIT_GROUPING
        label = f"ViT-S/16 {VIT_IMAGE_SIZE} bf16 batch {VIT_BATCH_PER_CHIP}"
    else:
        trainer, batch = make_train_parts()
        grouping = RESNET_GROUPING
        label = f"ResNet-50 s2d bf16 batch {BATCH_PER_CHIP}"
    n = len(batch["image"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for _ in range(3):
        trainer.train_step(batch)
    walls = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    events = prof.events()
    by_group = {g: us / 1e3 / STEPS
                for g, us in kernel_groups(events, grouping).items()}
    busy_ms = sum(by_group.values())
    print(f"[profile] {label}: wall "
          f"{wall_ms:.3f} ms/step ({n / wall_ms * 1e3:.1f} "
          f"images/s), device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), by group "
          f"{ {g: round(v, 3) for g, v in by_group.items()} } ({card})")
    totals: Dict[str, list] = {}
    for e in events:
        for k in e.kernels:
            t = totals.setdefault(k.name, [0.0, 0])
            t[0] += k.duration
            t[1] += 1
    conv_by_name = sum(us for name, (us, _) in totals.items()
                       if any(m in name.lower() for m in CONV_MARKERS))
    print(f"[profile] cross-check: kernels named as convolutions or "
          f"matmuls, wherever launched: {conv_by_name / 1e3 / STEPS:.3f} "
          f"ms/step")
    for name, (us, calls) in sorted(totals.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {us / 1e3 / STEPS:8.3f} ms  "
              f"x{calls / STEPS:.0f}  {name[:90]}")


if __name__ == "__main__":
    main()
