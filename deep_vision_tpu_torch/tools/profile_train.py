"""The training steps chip_smoke.py drives, and where their time goes on
the card.

    python -m deep_vision_tpu_torch.tools.profile_train [--model NAME]
        [--records DIR]

NAME is `resnet50` (the default), `vit_s16` or any other registered
config (`lenet5`, `vmoe_s16`, `yolov3_coco`, `hourglass_mpii`,
`centernet_coco`, `dcgan_mnist`, `cyclegan`, ...).

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

`make_zoo_parts` is any other registered classification or detection
config as `train_cli` builds it: the config's model, width, input,
batch, float32, optimizer and schedule (`build_trainer`), on the CLI's
seeded fake batch, under the CLI's precision (PyTorch's defaults: cuDNN
TF32 on, matmuls float32). Its groups are ResNet-50's (a ViT's: the
flash and LayerNorm groups).

`make_gan_parts` is a GAN config as `train_cli` builds it
(`build_gan_trainer`) and a step on its seeded fake batch: DCGAN's
whole batch of 256, CycleGAN's one A and one B image. Its groups are
ResNet-50's and `gan_pool`: what runs inside CycleGAN's host image-pool
query (train/gan.py `GAN_POOL_RANGE`: the fakes' copy to the host and
the pooled batch's copy back; the host time there is printed with the
other ranges).

`make_record_loader` is the fed ResNet step's input: record shards
(tools/synth_records.py) through a `RecordDataset`, the reference's
ImageNet train chain for the s2d stem (`imagenet_train_transform`,
train_cli.py:208-222) and a shuffling `DataLoader` of batch 128 with
`FEED_WORKERS`, whose batches `Trainer(device_prefetch=2)` places on the
card.

Run as a module (one CUDA card), it takes 3 warm-up steps, times 5
steps queued back to back (one synchronise at the end), times 5 steps
without the profiler, each ending in a synchronise, then profiles
5 more with torch.profiler and prints, per step: the wall time, the
device-busy time (the sum of kernel times, which do not overlap on one
stream), the busy share of the unprofiled wall time, kernel time by
group, each group's largest kernels, and the top kernels; and on the
host, the time to issue a step onto an idle card (unprofiled) and, from
the profiled steps' CPU trace, the time spent in each ranged group's
ranges (forward) and in the autograd nodes of the ops run in them
(backward), with their calls. With `--records DIR` the ResNet step is
fed from the shards in DIR through `make_record_loader` and the
Trainer's device prefetch, cycling over epochs: every step is timed
from when its placed batch is in hand, so the feed's threads count in
no step's issue time (the wait for a batch is printed apart, with the
feed's starvation counters and the main thread's CPU time a step), and
the copy stream's host-to-device copies are read from the raw trace
(the prefetcher's thread issues them outside any profiled op) and
printed apart from the device busy time, which they overlap.
ResNet-50 groups: `conv` (convolution and matmul kernels, forward and
backward), `bn_act_fwd` and `bn_act_bwd` (csrc/bn_act.cu), `bn_stats`
(csrc/norm.cu's moments kernels by name, and every other kernel launched
inside a BatchNorm's batch-statistics range or in the backward of those
operations, matched by autograd sequence number), `optimizer` (the
update) and `other`.
ViT groups: `flash_fwd`, `flash_dq`, `flash_dkv`
(csrc/flash_attention.cu), `matmul` (cuBLAS products and the patch
convolution, forward and backward), `layernorm` (csrc/norm.cu's
LayerNorm kernels by name, and other kernels inside a LayerNorm's range
and their backward), `optimizer` and `other`.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import time
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device
from deep_vision_tpu_torch.data import DataLoader, RecordDataset
from deep_vision_tpu_torch.data import transforms as T
from deep_vision_tpu_torch.data.pipeline import Compose
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.obs.registry import get_registry
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.nn.layers import BN_STATS_RANGE, LAYERNORM_RANGE
from deep_vision_tpu_torch.train import Trainer, build_optimizer
from deep_vision_tpu_torch.train.gan import GAN_POOL_RANGE
from deep_vision_tpu_torch.train.optimizers import make_schedule
from deep_vision_tpu_torch.tools.synth_records import raw_schema

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
#: the fed step's host workers: 4 spawned worker processes, the lowest
#: mean ms/step over chip_smoke's readings of every mode on the H100's
#: 8-core host, and the fastest on JPEG records in every reading (see
#: PERF.md, the fed step); `num_workers` is the thread count where a
#: caller sets num_procs 0
FEED_WORKERS = {"num_workers": 8, "num_procs": 4}
#: csrc/norm.cu, under the groups the eager statistics had
BN_STATS_KERNELS = {"bn_stats": ("bn_moments_fwd", "bn_moments_combine",
                                 "bn_moments_bwd")}
LAYERNORM_KERNELS = {"layernorm": ("layer_norm_fwd", "layer_norm_bwd")}
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


RESNET_GROUPING = Grouping({**BN_ACT_KERNELS, **BN_STATS_KERNELS},
                           {BN_STATS_RANGE: "bn_stats"}, "conv", GROUPS)
#: the GAN configs: ResNet's groups and `gan_pool`, the kernels and copies
#: inside CycleGAN's host image-pool query (train/gan.py GAN_POOL_RANGE:
#: the fakes to the host and the pooled batch back)
GAN_GROUPING = Grouping({**BN_ACT_KERNELS, **BN_STATS_KERNELS},
                        {BN_STATS_RANGE: "bn_stats",
                         GAN_POOL_RANGE: "gan_pool"}, "conv",
                        GROUPS[:-1] + ("gan_pool", "other"))
VIT_GROUPING = Grouping({**FLASH_KERNELS, **LAYERNORM_KERNELS},
                        {LAYERNORM_RANGE: "layernorm"}, "matmul", VIT_GROUPS)
STEPS = 5


def input_shape(stem: str) -> Tuple[int, ...]:
    """One image's NHWC shape for `stem` at IMAGE_SIZE: s2d (H/2, W/2,
    12), else (H, W, 3)."""
    if stem == "s2d":
        return (IMAGE_SIZE // 2, IMAGE_SIZE // 2, 12)
    return (IMAGE_SIZE, IMAGE_SIZE, 3)


def make_train_parts(batch_per_chip: int = BATCH_PER_CHIP, stem: str = "s2d",
                     device: DeviceLike = None,
                     dtype: torch.dtype = torch.bfloat16,
                     device_prefetch: int = 0, telemetry=None):
    """(trainer, batch): a Trainer over the seeded flagship model and one
    batch on its device. The batch is the reference's: `RandomState(0)`
    `rand` images cast to the compute dtype (bf16), then
    `randint(0, 1000)` labels. `dtype` exists for the float32 check
    against the plain path at a small batch; `device_prefetch` is the
    Trainer's, for the fed step; `telemetry` a TelemetryServer the
    Trainer registers its live sources with."""
    dev = resolve_device(device)
    model = get_model("resnet50", num_classes=NUM_CLASSES, dtype=dtype,
                      stem=stem, device=dev, seed=0, train=True)
    tx = build_optimizer("sgd", learning_rate=0.1, momentum=0.9,
                         weight_decay=1e-4)
    shape = input_shape(stem)
    sample = torch.ones((1, *shape), dtype=torch.float32)
    trainer = Trainer(model, tx, classification_loss_fn, sample, device=dev,
                      device_prefetch=device_prefetch, telemetry=telemetry)
    rng = np.random.RandomState(0)
    images = rng.rand(batch_per_chip, *shape).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, size=(batch_per_chip,))
    batch = {
        "image": torch.from_numpy(images).to(dtype).to(dev),
        "label": torch.from_numpy(labels.astype(np.int32)).to(dev),
    }
    return trainer, batch


#: the zoo's other classifiers, each trained as its registered config
ZOO_MODELS = ("lenet5", "alexnet1", "alexnet2", "vgg16", "vgg19",
              "inception1", "inception3", "resnet50v2", "mobilenet1",
              "shufflenet1")


def make_zoo_parts(name: str, device: DeviceLike = None):
    """(trainer, batch): the registered config `name` through
    train_cli's `build_trainer`, and its first seeded fake batch on the
    trainer's device."""
    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.train_cli import FAKE_DATA, build_trainer

    dev = resolve_device(device)
    cfg = get_config(name)
    host = FAKE_DATA[cfg.task](cfg, 1)[0]
    trainer = build_trainer(cfg, lambda: [host], None, device=dev)
    return trainer, {k: torch.as_tensor(v).to(dev) for k, v in host.items()}


def make_gan_parts(name: str, device: DeviceLike = None):
    """(trainer, step): a registered GAN config (`dcgan_mnist`,
    `cyclegan`) through train_cli's `build_gan_trainer`, and a function
    that takes one step on its first seeded fake batch on the trainer's
    device: DCGAN the whole batch, CycleGAN one A and one B image (the
    reference's feed; its registered batch of 1 leaves the CLI's B half
    empty)."""
    import dataclasses

    from deep_vision_tpu_torch.configs import get_config
    from deep_vision_tpu_torch.train_cli import FAKE_DATA, build_gan_trainer

    dev = resolve_device(device)
    cfg = get_config(name)
    if name == "cyclegan":
        cfg = dataclasses.replace(cfg, batch_size=2)
    images = torch.as_tensor(FAKE_DATA[cfg.task](cfg, 1)[0]["image"]).to(dev)
    trainer = build_gan_trainer(cfg, device=dev)
    if name == "cyclegan":
        return trainer, lambda: trainer.train_step(images[:1], images[1:2])
    return trainer, lambda: trainer.train_step(images)


def imagenet_train_transform(rescale: Optional[int] = 256) -> Compose:
    """The reference's ImageNet train chain for the s2d stem
    (train_cli.py:208-222): Rescale(rescale), RandomHorizontalFlip,
    RandomCrop(224), ColorJitter(0.4, 0.4, 0.4),
    ToFloatNormalize(expand_gray_to_rgb=True), SpaceToDepth. `rescale`
    None leaves the Rescale out, for images whose shorter side is already
    256 (the raw synthetic records)."""
    chain = [] if rescale is None else [T.Rescale(rescale)]
    return Compose(chain + [
        T.RandomHorizontalFlip(), T.RandomCrop(IMAGE_SIZE),
        T.ColorJitter(0.4, 0.4, 0.4),
        T.ToFloatNormalize(expand_gray_to_rgb=True), T.SpaceToDepth()])


def make_record_loader(pattern, encoding: str = "raw",
                       **workers) -> DataLoader:
    """A shuffling, remainder-dropping DataLoader of BATCH_PER_CHIP over
    the record shards of `pattern` (tools/synth_records.py's, in
    `encoding`: raw pixels through `raw_schema` without the Rescale, or
    JPEG through the `imagenet` schema with it) and the ImageNet train
    chain. `workers`: DataLoader's num_workers and num_procs,
    FEED_WORKERS by default."""
    raw = encoding == "raw"
    dataset = RecordDataset(pattern, raw_schema if raw else "imagenet",
                            shuffle_shards=True)
    return DataLoader(dataset, BATCH_PER_CHIP,
                      transform=imagenet_train_transform(None if raw
                                                         else 256),
                      shuffle=True, drop_remainder=True,
                      **{**FEED_WORKERS, **workers})


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


def _ranged_sequence(events, grouping: Grouping) -> Dict[int, str]:
    """autograd sequence number -> group, for the ops run inside a range"""
    seq = {}
    for e in events:
        if e.sequence_nr >= 0:
            g = _range_of(e, grouping.ranged)
            if g is not None:
                seq[e.sequence_nr] = g
    return seq


def kernels_by_group(events: Iterable, grouping: Grouping = RESNET_GROUPING
                     ) -> Dict[str, Dict[str, float]]:
    """Device microseconds by group and kernel name over the profiler's
    `events()`."""
    events = list(events)
    seq = _ranged_sequence(events, grouping)
    out: Dict[str, Dict[str, float]] = {g: {} for g in grouping.groups}
    for e in events:
        for k in e.kernels:
            names = out[_group(k.name, e, seq, grouping)]
            names[k.name] = names.get(k.name, 0.0) + k.duration
    return out


def kernel_groups(events: Iterable,
                  grouping: Grouping = RESNET_GROUPING) -> Dict[str, float]:
    """Device microseconds by group over the profiler's `events()`."""
    return {g: sum(names.values())
            for g, names in kernels_by_group(events, grouping).items()}


def host_by_range(events: Iterable, grouping: Grouping = RESNET_GROUPING
                  ) -> Dict[str, Dict[str, Tuple[float, int]]]:
    """Host microseconds and calls of each ranged group over the
    profiler's `events()`: {"forward": the ranges themselves, "backward":
    the autograd nodes of the ops run in them}. A range's device-side
    annotation, which the profiler records under the same name, is not a
    call."""
    events = list(events)
    seq = _ranged_sequence(events, grouping)
    out = {g: {"forward": (0.0, 0), "backward": (0.0, 0)}
           for g in set(grouping.ranged.values())}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in grouping.ranged:
            g, side = grouping.ranged[e.name], "forward"
        elif (e.name.startswith("autograd::engine::evaluate_function")
              and e.sequence_nr in seq):
            g, side = seq[e.sequence_nr], "backward"
        else:
            continue
        us, calls = out[g][side]
        out[g][side] = (us + e.cpu_time_total, calls + 1)
    return out


def h2d_ms(prof) -> float:
    """Device ms of every host-to-device copy in a finished profile, from
    its raw trace: the copies a prefetcher's thread issues belong to no
    profiled CPU op, so `events()` does not show them."""
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and e.name().startswith("Memcpy HtoD")) / 1e6


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


def _epochs(loader: DataLoader) -> Iterator[dict]:
    """The loader's batches, epoch after epoch, without end."""
    while True:
        yield from loader


def main() -> None:
    from deep_vision_tpu_torch.configs import CONFIG_REGISTRY
    from deep_vision_tpu_torch.models.vit import ViT
    from deep_vision_tpu_torch.train_cli import FAKE_DATA

    from deep_vision_tpu_torch.train_cli import GAN_TASKS

    own = ("resnet50", "vit_s16")  # the flagship steps above
    registered = tuple(name for name, cfg in CONFIG_REGISTRY.items()
                       if cfg.task in FAKE_DATA and name not in own)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="resnet50",
                        choices=own + registered)
    parser.add_argument("--records", metavar="DIR",
                        help="feed the ResNet step from the record shards "
                             "in DIR (tools/synth_records.py, raw)")
    args = parser.parse_args()
    gan_step = None
    if args.model == "vit_s16":
        trainer, batch = make_vit_train_parts()
        grouping = VIT_GROUPING
        label = f"ViT-S/16 {VIT_IMAGE_SIZE} bf16 batch {VIT_BATCH_PER_CHIP}"
    elif CONFIG_REGISTRY.get(args.model) and \
            CONFIG_REGISTRY[args.model].task in GAN_TASKS:
        trainer, gan_step = make_gan_parts(args.model)
        n_images = 2 if args.model == "cyclegan" else \
            CONFIG_REGISTRY[args.model].batch_size
        batch = {"image": torch.empty(n_images)}  # images a step
        grouping = GAN_GROUPING
        label = (f"{args.model} float32, {n_images} images a step (the "
                 f"registered config)")
    elif args.model in registered:
        trainer, batch = make_zoo_parts(args.model)
        grouping = (VIT_GROUPING if isinstance(trainer.model, ViT)
                    else RESNET_GROUPING)
        label = (f"{args.model} float32 batch {len(batch['image'])} (the "
                 f"registered config)")
    else:
        trainer, batch = make_train_parts(
            device_prefetch=2 if args.records else 0)
        grouping = RESNET_GROUPING
        label = f"ResNet-50 s2d bf16 batch {BATCH_PER_CHIP}"
    n = len(batch["image"])

    def take_step(item):
        if gan_step is not None:
            return gan_step()
        return trainer.train_step(item)

    if args.records:
        if args.model != "resnet50":
            parser.error("--records feeds the ResNet step")
        loader = make_record_loader(os.path.join(args.records, "*"))
        placed = trainer.prefetcher(_epochs(loader))
        label += (f", fed from {args.records} ({FEED_WORKERS}, "
                  f"device_prefetch 2)")
        waits = []  # the consumer's wait for each placed batch

        def next_batch():
            t0 = time.perf_counter()
            item = next(placed)
            waits.append((time.perf_counter() - t0) * 1e3)
            return item
    else:
        def next_batch():
            return batch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for _ in range(3):
        take_step(next_batch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        take_step(next_batch())
    torch.cuda.synchronize()
    queued_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    walls = []
    for _ in range(STEPS):
        item = next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        take_step(item)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    enqueue, cpu = [], []  # host time to issue a step onto an idle card
    for _ in range(STEPS):
        item = next_batch()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        take_step(item)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        cpu.append((time.thread_time() - c0) * 1e3)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            take_step(next_batch())
        torch.cuda.synchronize()
    events = prof.events()
    named = kernels_by_group(events, grouping)
    by_group = {g: sum(names.values()) / 1e3 / STEPS
                for g, names in named.items()}
    busy_ms = sum(by_group.values())
    print(f"[profile] {label}: wall "
          f"{wall_ms:.3f} ms/step ({n / wall_ms * 1e3:.1f} "
          f"images/s), queued back to back {queued_ms:.3f} ms/step, "
          f"device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), by group "
          f"{ {g: round(v, 3) for g, v in by_group.items()} } ({card})")
    host = host_by_range(events, grouping)
    print(f"[profile] host: a step issued in "
          f"{statistics.median(enqueue):.3f} ms (median of {STEPS}, no "
          f"profiler, from an idle card; the issuing thread's CPU time "
          f"{statistics.median(cpu):.3f} ms); in the profiled steps, "
          + "; ".join(
              f"{g} {side} {us / 1e3 / STEPS:.3f} ms over {calls // STEPS} "
              f"calls ({us / max(calls, 1):.1f} us a call)"
              for g, sides in sorted(host.items())
              for side, (us, calls) in sides.items()))
    if args.records:
        reg = get_registry()
        placed_starved = reg.counter("device_prefetch_starved_total",
                                     labels={"loader": "train"}).value
        host_starved = reg.counter("data_prefetch_starved_total",
                                   labels={"loader": "default"}).value
        place = reg.histogram("device_prefetch_place_ms",
                              labels={"loader": "train"})
        print(f"[profile] feed: wait for a placed batch median "
              f"{statistics.median(waits):.3f} ms, max {max(waits):.3f} ms "
              f"over {len(waits)} steps; device_prefetch_starved_total "
              f"{placed_starved:.0f}, data_prefetch_starved_total "
              f"{host_starved:.0f}; _place_one {place.mean:.3f} ms a batch "
              f"on the host (mean of {place.count}); host-to-device copies "
              f"{h2d_ms(prof) / STEPS:.3f} ms/step on the card")
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
    for g, names in named.items():
        top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
        print(f"[profile] {g}: " + "; ".join(
            f"{us / 1e3 / STEPS:.3f} ms {name[:100]}" for name, us in top))
    for name, (us, calls) in sorted(totals.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {us / 1e3 / STEPS:8.3f} ms  "
              f"x{calls / STEPS:.0f}  {name[:90]}")


if __name__ == "__main__":
    main()
