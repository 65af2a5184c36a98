"""The training CLI, the port of deep_vision_tpu/train_cli.py.

    python -m deep_vision_tpu_torch.train_cli -m resnet50 --data-dir D \\
        --ckpt-dir C [-c auto|DIR] [--epochs N] [--device cuda|cpu]

trains a registered config (configs/__init__.py), every one of them, and
evaluates it every epoch where the task has a Trainer.
Classification reads ImageNet-layout records `D/tfrecord_train/*`
and `D/tfrecord_val/*` (the flattened-folder layout `D/train_flatten`,
`D/val_flatten` where no train records exist; MNIST idx files
`D/train-images-idx3-ubyte`, `D/train-labels-idx1-ubyte`,
`D/t10k-images-idx3-ubyte` and `D/t10k-labels-idx1-ubyte` for the
`mnist` kind of lenet5 and dcgan_mnist). Every `records` config reads
`D/train*` and `D/val*` in its schema: detection (`yolov3_coco`,
`yolov3_voc`) and CenterNet (`centernet_coco`) box records as
`python -m deep_vision_tpu_torch.tools.convert voc|coco` writes them,
pose (`hourglass_mpii`) MPII keypoint records (`convert mpii`) and
CycleGAN's image-only records (`convert cyclegan`).
`--fake-data` takes the reference's seeded fake batches instead. It
runs the config's optimizer, schedule or plateau, a checkpoint
with its crc32c sidecar after each epoch, a SIGTERM save at the next
step boundary (the process then exits with the requeue code 75,
EX_TEMPFAIL, so a scheduler resubmits it; 0 is a finished run), and
`-c` resuming where the
checkpoint left off: parameters, momentum, BatchNorm running statistics,
the step counter, the plateau, the loggers and, with `--data-snapshot`,
the batch stream. `--eval-only` evaluates a checkpoint: loss and top-k
for classification; for detection, mAP@.5 and mAP@[.5:.95] over the
val split through the YOLO detector at score 0.1, whose NMS runs on the
card, and for CenterNet through its peak decode; for pose, PCKh@0.5
where the records carry head sizes, else PCK@0.05 of the image side.
The GAN tasks (`dcgan_mnist`, `cyclegan`) train through their own
trainers (train/gan.py) as the reference's GAN branch does: per-epoch
means of the G and D losses, a checkpoint of every sub-network each
epoch (DCGAN, the newest 3 kept) or every 2 (CycleGAN), `-c` resuming
at the next epoch, a SIGTERM save that re-runs the interrupted epoch;
they refuse `--eval-only` and `--data-snapshot`. CycleGAN splits each
batch into its A and B halves; at its registered batch of 1 the B half
is empty and the image pool raises, as in the reference. It runs on the
card unless `--device cpu` is given, and raises without one.

Ported: `model_input_shape`, the fake-data makers, `build_dataloaders`
(fake, mnist, imagenet, and the records kind of every task, with both
`--preprocessing` chains and the s2d host transform), `_steps_per_epoch`,
`_build_schedule`, `build_trainer`, `build_gan_trainer`,
`run_eval_only` and `main` with the flags below. Every other reference
flag is unknown here, so argparse fails on it loudly.

The run's black box (obs/): `--journal` writes typed events;
`--trace PATH` installs a span tracer and writes a Chrome trace of the
nested spans (train/epoch, train/step, eval, checkpoint/*, data/*,
gan/*), valid JSON mid-run; `--flight-dir DIR` installs the flight
recorder, which leaves a crc-checked bundle under DIR on SIGTERM
(`preempt`), a health abort, a hang, an injected crash or an exit
without a clean close, and none on a clean exit; `DVT_LOCKSMITH=1`
arms the lock-order sanitizer, whose findings land in the journal as
`lock_order_violation` / `lock_contention` events.

The per-step record (obs/stepclock.py): every training step's journal
`step` row carries StepClock's breakdown (step_time_ms, data_wait_ms,
dispatch_ms, examples_per_sec; sync_ms, recompiles, hbm_bytes and
hbm_peak_bytes on the steps the fence samples, every
`--telemetry-sample-every`, 16 by default, for the Trainer and the GAN
trainers alike). `--tensorboard-dir DIR` writes TensorBoard
scalars through both loggers (core/tensorboard.py); `--metrics-export
PATH` writes the metrics registry as Prometheus text after the run;
`--summary` prints the parameter table before training (one for the
Trainer's model, one each for a GAN's G and D).

The live plane (obs/telemetry.py): `--telemetry-port PORT` (else
`DVT_TELEMETRY`; 0 binds a free port) serves /metrics, /varz, /healthz,
/statusz and /alertz over HTTP while the run lasts, journals the bound
port as a `telemetry_server` event, prints `telemetry:
http://<addr>/statusz` and writes a discovery file
`telemetry-train-<pid>.json` under the checkpoint dir, which
`python -m deep_vision_tpu_torch.tools.obs_poll --run-dir DIR` reads.
The Trainer registers its `train` and `perf` status and, with a health
monitor, the `train` health source; the GAN loop the health source
only. A knob that does not parse or a port that does not bind is a
warning on stderr, and the run goes on without the endpoints.

Float32 precision: the CLI keeps PyTorch's defaults, which no registered
config overrides, and prints them at start-up: cuDNN convolutions may
use TF32 (`torch.backends.cudnn.allow_tf32`, True by default) and cuBLAS
matmuls do not (`torch.backends.cuda.matmul.allow_tf32`, False). On a
TPU float32 convolutions have no such switch; this is the port's choice.
`DVT_DETERMINISTIC=1` (core/knobs.py) runs under
`torch.use_deterministic_algorithms(True)` with cudnn.benchmark off and
CUBLAS_WORKSPACE_CONFIG=:4096:8 set before CUDA starts, so a run and its
resume repeat bitwise.

`--executable-cache DIR` (else `DVT_EXCACHE`) attaches an executable
cache (core/excache.py) to the run: the compiled libraries load from
DIR, a miss is compiled into it, and its excache_* events land in the
journal. The reference also points JAX's own compilation cache at
DIR/xla; the port traces nothing, so there is no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import os
from typing import List, Optional

import numpy as np
import torch

from deep_vision_tpu_torch.configs import (
    CONFIG_REGISTRY,
    ExperimentConfig,
    get_config,
)
from deep_vision_tpu_torch.core import knobs
from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device


def model_input_shape(cfg: ExperimentConfig):
    """The shape the model consumes: cfg.input_shape after any host-side
    layout transform (stem='s2d' takes (H/2, W/2, 4C))."""
    h, w, c = cfg.input_shape
    if cfg.model_kwargs.get("stem") == "s2d":
        return (h // 2, w // 2, 4 * c)
    return cfg.input_shape


def _fake_classification(cfg: ExperimentConfig, n_batches: int):
    rng = np.random.RandomState(0)
    h, w, c = model_input_shape(cfg)
    return [
        {"image": rng.rand(cfg.batch_size, h, w, c).astype(np.float32),
         "label": rng.randint(0, cfg.num_classes,
                              (cfg.batch_size,)).astype(np.int32)}
        for _ in range(n_batches)]


def _fake_detection(cfg: ExperimentConfig, n_batches: int,
                    max_boxes: int = 20):
    """The reference's seeded fake detection batches, draw for draw:
    1-4 boxes an image (xyxy in [0, 0.95]) with classes, zero padding,
    and uniform images."""
    rng = np.random.RandomState(0)
    h, w, c = cfg.input_shape
    out = []
    for _ in range(n_batches):
        boxes = np.zeros((cfg.batch_size, max_boxes, 4), np.float32)
        classes = np.zeros((cfg.batch_size, max_boxes), np.int32)
        for b in range(cfg.batch_size):
            n = rng.randint(1, 5)
            x1 = rng.uniform(0, 0.6, n)
            y1 = rng.uniform(0, 0.6, n)
            boxes[b, :n, 0], boxes[b, :n, 1] = x1, y1
            boxes[b, :n, 2] = x1 + rng.uniform(0.1, 0.35, n)
            boxes[b, :n, 3] = y1 + rng.uniform(0.1, 0.35, n)
            classes[b, :n] = rng.randint(0, cfg.num_classes, n)
        out.append({"image": rng.rand(cfg.batch_size, h, w, c).astype(
            np.float32), "boxes": boxes, "classes": classes})
    return out


def _fake_pose(cfg: ExperimentConfig, n_batches: int, hm_size: int = 64):
    """The reference's seeded fake pose batches: uniform keypoints, all
    visible, their heatmaps, and uniform images."""
    from deep_vision_tpu_torch.data.labels import make_pose_heatmaps

    rng = np.random.RandomState(0)
    h, w, c = cfg.input_shape
    out = []
    for _ in range(n_batches):
        hms, kps, viss = [], [], []
        for _b in range(cfg.batch_size):
            s = {"keypoints": rng.rand(cfg.num_classes, 2).astype(
                     np.float32),
                 "visibility": np.ones((cfg.num_classes,), np.float32)}
            hms.append(make_pose_heatmaps(s, size=hm_size,
                                          num_joints=cfg.num_classes)[
                                              "heatmap"])
            kps.append(s["keypoints"])
            viss.append(s["visibility"])
        out.append({"image": rng.rand(cfg.batch_size, h, w, c).astype(
                        np.float32),
                    "heatmap": np.stack(hms), "keypoints": np.stack(kps),
                    "visibility": np.stack(viss)})
    return out


def _fake_centernet(cfg: ExperimentConfig, n_batches: int):
    """The fake detection batches with their CenterNet targets at a
    quarter of the input; the raw boxes ride along for --eval-only."""
    from deep_vision_tpu_torch.data.labels import make_centernet_targets

    out_size = cfg.input_shape[0] // 4
    out = []
    for batch in _fake_detection(cfg, n_batches):
        tgts = [make_centernet_targets(
            {"boxes": batch["boxes"][b], "classes": batch["classes"][b]},
            out_size=out_size, num_classes=cfg.num_classes)
            for b in range(len(batch["image"]))]
        out.append({"image": batch["image"], "boxes": batch["boxes"],
                    "classes": batch["classes"],
                    **{k: np.stack([t[k] for t in tgts])
                       for k in ("heatmap", "wh", "offset", "mask")}})
    return out


#: the fake-data makers by task (the GANs take the classification
#: batches' images)
FAKE_DATA = {"classification": _fake_classification,
             "detection": _fake_detection,
             "pose": _fake_pose,
             "centernet": _fake_centernet,
             "dcgan": _fake_classification,
             "cyclegan": _fake_classification}


def imagenet_transforms(cfg: ExperimentConfig, preprocessing: str = "torch"):
    """(train, eval) ImageNet chains: "torch" is the torchvision-stats
    chain, "tf" the 0-255 mean-subtraction variant; the s2d stem appends
    SpaceToDepth (train_cli.py:174-222)."""
    from deep_vision_tpu_torch.data import Compose
    from deep_vision_tpu_torch.data import transforms as T

    if preprocessing == "tf":
        train_tf = Compose([
            T.Rescale(cfg.train_resize), T.RandomHorizontalFlip(),
            T.RandomCrop(cfg.eval_crop),
            T.ToFloat(expand_gray_to_rgb=True, scale=False),
            T.MeanSubtract()])
        eval_tf = Compose([
            T.Rescale(cfg.train_resize), T.CenterCrop(cfg.eval_crop),
            T.ToFloat(expand_gray_to_rgb=True, scale=False),
            T.MeanSubtract()])
    else:
        train_tf = Compose([
            T.Rescale(cfg.train_resize), T.RandomHorizontalFlip(),
            T.RandomCrop(cfg.eval_crop), T.ColorJitter(0.4, 0.4, 0.4),
            T.ToFloatNormalize(expand_gray_to_rgb=True)])
        eval_tf = Compose([
            T.Rescale(cfg.train_resize), T.CenterCrop(cfg.eval_crop),
            T.ToFloatNormalize(expand_gray_to_rgb=True)])
    if cfg.model_kwargs.get("stem") == "s2d":
        train_tf = Compose([train_tf, T.SpaceToDepth()])
        eval_tf = Compose([eval_tf, T.SpaceToDepth()])
    return train_tf, eval_tf


def build_dataloaders(cfg: ExperimentConfig, data_dir: str, fake: bool,
                      fake_batches: int, num_workers: int,
                      preprocessing: str = "torch", num_procs: int = 0):
    """(train_fn, eval_fn) thunks yielding batch dicts per epoch: the
    reference's fake batches, its ImageNet records (folder where
    `tfrecord_train` holds no shard), MNIST, or a records config's
    shards (`records_dataloaders`), through the port's data layer."""
    if fake or cfg.dataset.get("kind") == "fake":
        data = FAKE_DATA[cfg.task](cfg, fake_batches)
        return (lambda: data), (lambda: data)
    kind = cfg.dataset["kind"]
    if kind == "records":
        return records_dataloaders(cfg, data_dir, num_workers, num_procs)
    if kind not in ("imagenet", "mnist"):
        raise ValueError(f"unknown dataset kind {kind!r}")
    from deep_vision_tpu_torch.data import (
        DataLoader,
        MnistDataset,
        RecordDataset,
    )
    from deep_vision_tpu_torch.data.datasets import ImageFolderDataset

    if kind == "mnist":  # 28x28 padded to 32x32 by the dataset
        from deep_vision_tpu_torch.data import Compose
        from deep_vision_tpu_torch.data import transforms as T

        train_ds, eval_ds = (MnistDataset(
            os.path.join(data_dir, f"{split}-images-idx3-ubyte"),
            os.path.join(data_dir, f"{split}-labels-idx1-ubyte"))
            for split in ("train", "t10k"))
        tf_ = Compose([T.ToFloat(), T.Normalize(mean=[0.1307], std=[0.3081])])
        train = DataLoader(train_ds, cfg.batch_size, tf_, shuffle=True,
                           num_workers=num_workers, num_procs=num_procs,
                           name="train")
        evl = DataLoader(eval_ds, cfg.batch_size, tf_,
                         num_workers=num_workers, name="val")
        return (lambda: train), (lambda: evl)

    train_tf, eval_tf = imagenet_transforms(cfg, preprocessing)
    rec_glob = os.path.join(data_dir, "tfrecord_train", "*")
    if glob.glob(rec_glob):
        train_ds = RecordDataset(rec_glob, "imagenet", shuffle_shards=True)
        eval_ds = RecordDataset(os.path.join(data_dir, "tfrecord_val", "*"),
                                "imagenet")
        train = DataLoader(train_ds, cfg.batch_size, train_tf, shuffle=True,
                           shuffle_buffer=10000, num_workers=num_workers,
                           num_procs=num_procs, name="train")
    else:
        train_ds = ImageFolderDataset(os.path.join(data_dir,
                                                   "train_flatten"))
        eval_ds = ImageFolderDataset(os.path.join(data_dir, "val_flatten"))
        train = DataLoader(train_ds, cfg.batch_size, train_tf, shuffle=True,
                           num_workers=num_workers, num_procs=num_procs,
                           name="train")
    evl = DataLoader(eval_ds, cfg.batch_size, eval_tf,
                     num_workers=num_workers, name="val")
    return (lambda: train), (lambda: evl)


def records_dataloaders(cfg: ExperimentConfig, data_dir: str,
                        num_workers: int, num_procs: int = 0):
    """The records kind (train_cli.py:245-300): `train_glob` /
    `val_glob` (default train*, val*) under `data_dir` in the config's
    schema, through the task's chains. Detection: flip, crop around the
    boxes, resize, scale to [0, 1], pad the boxes to 100 (eval: resize,
    scale, pad). Pose: the keypoint-driven person crop with a margin
    drawn from [0.1, 0.3) (eval: 0.2), the MPII left/right-swapping flip,
    resize, scale and the 64x64 heatmaps. CenterNet: flip, resize, scale,
    pad and the targets at a quarter of the input (eval: no flip). Any
    other task (the GANs' image-only records): resize and scale to
    [-1, 1], the same chain for both splits. Partial batches are
    dropped."""
    from deep_vision_tpu_torch.data import Compose, DataLoader, RecordDataset
    from deep_vision_tpu_torch.data import transforms as T
    from deep_vision_tpu_torch.data.labels import (
        MakeCenternetTargets,
        MakePoseHeatmaps,
    )

    size = cfg.input_shape[0]
    schema = cfg.dataset["schema"]
    if cfg.task == "detection":
        train_chain = [T.RandomHorizontalFlip(), T.RandomCropWithBoxes(),
                       T.Resize(size), T.ToFloat(), T.PadBoxes(100)]
        eval_chain = [T.Resize(size), T.ToFloat(), T.PadBoxes(100)]
    elif cfg.task == "pose":
        train_chain = [T.CropRoi(margin=(0.1, 0.3)),
                       T.RandomHorizontalFlip(
                           keypoint_swap_pairs=T.MPII_FLIP_PAIRS),
                       T.Resize(size), T.ToFloat(),
                       MakePoseHeatmaps(num_joints=cfg.num_classes)]
        eval_chain = [T.CropRoi(margin=0.2), T.Resize(size), T.ToFloat(),
                      MakePoseHeatmaps(num_joints=cfg.num_classes)]
    elif cfg.task == "centernet":
        targets = MakeCenternetTargets(size // 4, cfg.num_classes)
        train_chain = [T.RandomHorizontalFlip(), T.Resize(size),
                       T.ToFloat(), T.PadBoxes(100), targets]
        eval_chain = [T.Resize(size), T.ToFloat(), T.PadBoxes(100),
                      targets]
    else:  # image_only (GANs): scale to [-1, 1]
        train_chain = [T.Resize(size), T.ToFloat(),
                       T.Normalize(mean=[0.5] * cfg.input_shape[2],
                                   std=[0.5] * cfg.input_shape[2])]
        eval_chain = train_chain
    train_ds = RecordDataset(
        os.path.join(data_dir, cfg.dataset.get("train_glob", "train*")),
        schema, shuffle_shards=True)
    eval_ds = RecordDataset(
        os.path.join(data_dir, cfg.dataset.get("val_glob", "val*")), schema)
    train = DataLoader(train_ds, cfg.batch_size, Compose(train_chain),
                       shuffle=True, num_workers=num_workers,
                       num_procs=num_procs, drop_remainder=True,
                       name="train")
    evl = DataLoader(eval_ds, cfg.batch_size, Compose(eval_chain),
                     num_workers=num_workers, drop_remainder=True,
                     name="val")
    return (lambda: train), (lambda: evl)


def _steps_per_epoch(cfg: ExperimentConfig, train_fn) -> int:
    data = train_fn()
    try:
        return len(data)
    except TypeError:
        return 1000  # streaming: nominal epoch length


def _build_schedule(cfg: ExperimentConfig, steps_per_epoch: int):
    from deep_vision_tpu_torch.train.optimizers import make_schedule

    base_lr = cfg.optimizer["learning_rate"]
    if cfg.schedule is None:
        return base_lr
    kw = dict(cfg.schedule)
    kind = kw.pop("kind")
    for epochs_key, steps_key in (("step_size_epochs", "step_size"),
                                  ("total_epochs", "total_steps"),
                                  ("hold_epochs", "hold_steps"),
                                  ("warmup_epochs", "warmup_steps")):
        if epochs_key in kw:
            kw[steps_key] = kw.pop(epochs_key) * steps_per_epoch
    return make_schedule(kind, base_lr, **kw)


def build_model(cfg: ExperimentConfig, device: DeviceLike = None):
    """The config's model with seeded weights, in training mode; a model
    the port lacks raises get_model's "unknown model", naming it."""
    from deep_vision_tpu_torch.models import get_model

    return get_model(cfg.model, num_classes=cfg.num_classes, device=device,
                     train=True, **cfg.model_kwargs)


def build_trainer(cfg: ExperimentConfig, train_fn, ckpt_dir: Optional[str],
                  ema_decay: Optional[float] = None, journal=None,
                  health=None, device_prefetch: int = 0,
                  opt_state_dtype: Optional[str] = None, data_loader=None,
                  steps_per_epoch: Optional[int] = None,
                  device: DeviceLike = None, executable_cache=None,
                  tb_dir: Optional[str] = None,
                  telemetry_sample_every: int = 16, telemetry=None):
    """The reference's build_trainer, on `device` (default cuda, raising
    without a card). Detection trains on `yolo_train_loss_fn` with the
    grids of the input size (s/32, s/16, s/8), pose on
    `hourglass_loss_fn`, CenterNet on `centernet_loss_fn`; the GAN tasks
    raise ValueError (`build_gan_trainer` builds theirs). With `tb_dir`,
    both loggers write to one TensorBoard `SummaryWriter` there, which
    the caller closes (`trainer.logger.tb`); `telemetry_sample_every` is
    the StepClock's fence cadence; `telemetry` a TelemetryServer the
    Trainer registers its sources with."""
    from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
    from deep_vision_tpu_torch.core.metrics import MetricLogger
    from deep_vision_tpu_torch.losses import (
        centernet_loss_fn,
        classification_loss_fn,
        hourglass_loss_fn,
        yolo_train_loss_fn,
    )
    from deep_vision_tpu_torch.obs.registry import get_registry
    from deep_vision_tpu_torch.train import Trainer, build_optimizer
    from deep_vision_tpu_torch.train.optimizers import ReduceLROnPlateau

    dev = resolve_device(device)
    if cfg.task in GAN_TASKS:
        raise ValueError(f"task {cfg.task!r} uses a GAN trainer, not "
                         f"Trainer")
    steps = (steps_per_epoch if steps_per_epoch is not None
             else _steps_per_epoch(cfg, train_fn))
    opt_kw = dict(cfg.optimizer)
    name = opt_kw.pop("name")
    opt_kw.pop("learning_rate")
    lr = _build_schedule(cfg, steps)
    wd = opt_kw.pop("weight_decay", 0.0)
    tx = build_optimizer(name, lr, weight_decay=wd, decay_bn_bias=True,
                         state_dtype=opt_state_dtype, **opt_kw)
    model = build_model(cfg, dev)
    if cfg.task == "detection":
        size = cfg.input_shape[0]
        loss_fn = functools.partial(
            yolo_train_loss_fn, grid_sizes=(size // 32, size // 16, size // 8),
            num_classes=cfg.num_classes, **cfg.loss_kwargs)
    else:
        loss_fn = functools.partial(
            {"classification": classification_loss_fn,
             "pose": hourglass_loss_fn,
             "centernet": centernet_loss_fn}[cfg.task], **cfg.loss_kwargs)
    plateau = ReduceLROnPlateau(**cfg.plateau) if cfg.plateau else None
    ckpt = CheckpointManager(ckpt_dir, journal=journal) if ckpt_dir else None
    sample = torch.ones((2, *model_input_shape(cfg)), dtype=torch.float32)
    tb = None
    if tb_dir:
        from deep_vision_tpu_torch.core.tensorboard import SummaryWriter

        tb = SummaryWriter(tb_dir)
    logger = MetricLogger(tb_writer=tb, name="train",
                          registry=get_registry(), journal=journal)
    eval_logger = MetricLogger(tb_writer=tb, name="val", print_every=0,
                               registry=get_registry())
    return Trainer(model, tx, loss_fn, sample, device=dev,
                   lr_schedule=lr if callable(lr) else None,
                   device_prefetch=device_prefetch, plateau=plateau,
                   plateau_metric=cfg.plateau_metric,
                   checkpoint_manager=ckpt, logger=logger,
                   eval_logger=eval_logger, ema_decay=ema_decay,
                   journal=journal, health=health, data_loader=data_loader,
                   executable_cache=executable_cache,
                   telemetry_sample_every=telemetry_sample_every,
                   telemetry=telemetry)


#: the tasks trained by train/gan.py's trainers, not by Trainer
GAN_TASKS = ("dcgan", "cyclegan")


def build_gan_trainer(cfg: ExperimentConfig, health=None,
                      device: DeviceLike = None, journal=None,
                      telemetry_sample_every: int = 32):
    """The reference's build_gan_trainer (train_cli.py:435-466): a
    DcganTrainer or a CycleGanTrainer on `device` (default cuda), each
    sub-network with its own optimizer from the config's (name, learning
    rate and the rest), and seeded weights (seeds 0, 1, ... in the
    reference's order of sub-networks). As in the reference, the
    config's `schedule` is not applied: the learning rate stays the
    config's. Each trainer's StepClock (fenced every
    `telemetry_sample_every` steps) writes its step rows to
    `journal`."""
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.train import build_optimizer
    from deep_vision_tpu_torch.train.gan import CycleGanTrainer, DcganTrainer

    dev = resolve_device(device)
    opt_kw = dict(cfg.optimizer)
    name = opt_kw.pop("name")
    lr = opt_kw.pop("learning_rate")

    def model(kind, seed):
        return get_model(kind, device=dev, seed=seed, train=True)

    def tx_fn():
        return build_optimizer(name, lr, **opt_kw)

    if cfg.task == "dcgan":
        return DcganTrainer(
            model("dcgan_generator", 0), model("dcgan_discriminator", 1),
            tx_fn(), tx_fn(), image_shape=cfg.input_shape, device=dev,
            health=health, journal=journal,
            telemetry_sample_every=telemetry_sample_every)
    if cfg.task != "cyclegan":
        raise ValueError(f"task {cfg.task!r} has no GAN trainer")
    return CycleGanTrainer(
        model("cyclegan_generator", 0), model("cyclegan_generator", 1),
        model("cyclegan_discriminator", 2),
        model("cyclegan_discriminator", 3), tx_fn, tx_fn,
        image_shape=cfg.input_shape, device=dev, health=health,
        journal=journal, telemetry_sample_every=telemetry_sample_every)


def run_eval_only(cfg: ExperimentConfig, trainer, eval_fn) -> dict:
    """Evaluate the (restored) state on the val split
    (train_cli.py:469-538): classification loss and top-k; detection
    mAP@.5 and mAP@[.5:.95] from the YOLO detector (score 0.1, NMS on
    the trainer's device) or CenterNet's peak decode, with
    `DetectionEvaluator`; pose PCKh@0.5 when every val batch carries a
    head size, image-normalised PCK@0.05 when none does."""
    if cfg.task == "classification":
        summary = trainer.evaluate(eval_fn())
        print("eval: " + " ".join(f"{k}={v:.4f}"
                                  for k, v in summary.items()))
        return summary
    if cfg.task not in ("detection", "centernet", "pose"):
        raise ValueError(f"--eval-only unsupported for task {cfg.task!r}")
    from deep_vision_tpu_torch import inference

    model = trainer.model.eval()
    variables = dict(model.state_dict())
    if cfg.task == "pose":
        return _eval_pose(inference.make_pose_estimator(
            model, device=trainer.device), variables, eval_fn)
    from deep_vision_tpu_torch.core.detection_metrics import (
        DetectionEvaluator,
    )

    if cfg.task == "detection":
        detect = inference.make_yolo_detector(model, device=trainer.device,
                                              score_threshold=0.1)
    else:
        detect = inference.make_centernet_detector(model,
                                                   device=trainer.device)
    ev = DetectionEvaluator(cfg.num_classes)
    for batch in eval_fn():
        out = {k: v.cpu().numpy() for k, v in
               detect(variables, batch["image"]).items()}
        for i in range(len(batch["image"])):
            ev.add(out["boxes"][i], out["scores"][i], out["classes"][i],
                   batch["boxes"][i], batch["classes"][i])
    res = ev.compute(iou_threshold=0.5)
    coco = ev.compute_coco()
    print(f"eval: mAP@.5={res['mAP']:.4f} "
          f"mAP@[.5:.95]={coco['mAP@[.5:.95]']:.4f} "
          f"images={res['num_images']}")
    return {"mAP@.5": res["mAP"], **coco}


def _eval_pose(estimate, variables, eval_fn) -> dict:
    """PCK over the val split from the last stack's argmax keypoints;
    PCKh@0.5 with the batches' `head_size`, else PCK@0.05 (coordinates
    in [0, 1], so a norm of 1 is the image side)."""
    from deep_vision_tpu_torch.core.detection_metrics import pck

    preds, gts, viss, norms = [], [], [], []
    head_flags = set()
    for batch in eval_fn():
        kpts = estimate(variables, batch["image"]).cpu().numpy()
        preds.append(kpts[..., :2])
        gts.append(np.asarray(batch["keypoints"]))
        viss.append(np.asarray(
            batch.get("visibility", np.ones(kpts.shape[:2]))) > 0)
        head_flags.add("head_size" in batch)
        norms.append(np.asarray(batch.get("head_size", np.ones(len(kpts)))))
    if len(head_flags) > 1:
        raise ValueError(
            "eval batches are inconsistent: some carry 'head_size', some "
            "don't — PCKh and image-normalized PCK cannot be mixed")
    alpha = 0.5 if head_flags == {True} else 0.05
    out = pck(np.concatenate(preds), np.concatenate(gts),
              np.concatenate(viss), np.concatenate(norms), alpha=alpha)
    key = [k for k in out if k.startswith("PCK")][0]
    print(f"eval: {key}={out[key]:.4f} visible={out['num_visible']}")
    return out


def _deterministic() -> str:
    """Apply DVT_DETERMINISTIC before CUDA starts; describe the mode."""
    if not knobs.get_int("DVT_DETERMINISTIC"):
        return "off"
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    workspace = os.environ["CUBLAS_WORKSPACE_CONFIG"]
    return f"on (CUBLAS_WORKSPACE_CONFIG={workspace})"


def _make_journal(args, cfg: ExperimentConfig):
    if not args.journal:
        return None
    from deep_vision_tpu_torch.obs.journal import RunJournal
    from deep_vision_tpu_torch.resilience import installed

    journal = RunJournal(args.journal, kind="train")
    journal.manifest(config=dataclasses.asdict(cfg), device=args.device)
    inj = installed()
    if inj is not None:
        inj.set_journal(journal)
    return journal


def _make_tracer(args, journal):
    """--trace: install the process-wide span tracer; the journal notes
    the trace's path."""
    if not args.trace:
        return None
    from deep_vision_tpu_torch.obs.trace import Tracer, set_tracer

    tracer = Tracer(args.trace,
                    run_id=journal.run_id if journal is not None else None)
    set_tracer(tracer)
    if journal is not None:
        journal.write("note", trace_path=args.trace)
    return tracer


def _make_flight(args, journal):
    """--flight-dir: install the flight recorder, which taps the journal
    for its ring buffers and is the process-wide recorder that the
    preemption guard, the fault injector and the data loader reach
    without a handle."""
    if not args.flight_dir:
        return None
    from deep_vision_tpu_torch.obs.flight import FlightRecorder, set_flight

    flight = FlightRecorder(
        args.flight_dir,
        run_id=journal.run_id if journal is not None else None)
    set_flight(flight)
    if journal is not None:
        flight.attach(journal)
    return flight


def _make_health(args, journal):
    """--health-policy / --watchdog-timeout: either alone activates the
    monitor (a watchdog alone keeps the default `warn`, marked as not
    chosen, so the fatal divergence check stays)."""
    if args.health_policy is None and args.watchdog_timeout is None:
        return None
    from deep_vision_tpu_torch.obs.health import HealthMonitor

    health = HealthMonitor(policy=args.health_policy or "warn",
                           journal=journal,
                           watchdog_timeout=args.watchdog_timeout,
                           policy_explicit=args.health_policy is not None)
    if journal is not None:
        journal.add_closer(health.stop)
    return health


def _make_telemetry(args, journal, flight, discovery_dir: str,
                    role: str = "train"):
    """--telemetry-port, else DVT_TELEMETRY: the started TelemetryServer,
    or None. A knob that does not parse or a failed bind is a warning:
    the telemetry plane never kills the run it observes."""
    import sys

    port = args.telemetry_port
    if port is None:
        try:
            port = knobs.get_int("DVT_TELEMETRY")
        except knobs.KnobError as e:
            print(f"warning: {e}; telemetry disabled", file=sys.stderr)
            return None
    if port is None:
        return None
    from deep_vision_tpu_torch.obs.registry import get_registry
    from deep_vision_tpu_torch.obs.telemetry import TelemetryServer

    tele = TelemetryServer(port=port, role=role, registry=get_registry(),
                           journal=journal, flight=flight,
                           discovery_dir=discovery_dir)
    try:
        tele.start()
    except OSError as e:
        print(f"warning: telemetry server failed to bind port {port} "
              f"({e}); continuing without live endpoints", file=sys.stderr)
        return None
    if journal is not None:
        # an abnormal unwind closes it with the journal; close is
        # idempotent, so _finish closing it first is a no-op here
        journal.add_closer(tele.close)
    print(f"telemetry: http://{tele.address}/statusz", flush=True)
    return tele


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="deep_vision_tpu_torch trainer "
                    "(python -m deep_vision_tpu_torch.train_cli -m <config> "
                    "[-c ckpt])")
    p.add_argument("-m", "--model", required=True,
                   choices=sorted(CONFIG_REGISTRY))
    p.add_argument("-c", "--checkpoint", default=None,
                   help="resume: checkpoint dir (or 'auto' for --ckpt-dir)")
    p.add_argument("--data-dir", default="./dataset")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=8,
                   help="decode thread pool size")
    p.add_argument("--num-procs", type=int, default=0,
                   help="decode worker processes (0: threads only)")
    p.add_argument("--fake-data", action="store_true")
    p.add_argument("--fake-batches", type=int, default=4)
    p.add_argument("--preprocessing", default="torch",
                   choices=["torch", "tf"],
                   help="ImageNet chain: torchvision stats or the TF 0-255 "
                        "mean-subtraction variant")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="append typed run events to this JSONL")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON of the run's "
                        "spans (load in Perfetto / chrome://tracing)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="flight recorder: ring-buffer the recent steps, "
                        "health events, journal and span tail, and dump a "
                        "crc-checked bundle under DIR on a crash, hang, "
                        "health abort or preemption (obs/flight.py; "
                        "validate with obs.flight.validate_bundle)")
    p.add_argument("--health-policy", default=None,
                   choices=["warn", "skip_step", "abort"],
                   help="non-finite loss/grad-norm policy (obs/health.py)")
    p.add_argument("--watchdog-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="dump every thread's stack if no step completes "
                        "within this deadline")
    p.add_argument("--data-snapshot", action="store_true",
                   help="checkpoint the train DataLoader's position with the "
                        "model, so a resume replays the same batch stream "
                        "(needs a real dataset and --num-procs 0)")
    p.add_argument("--eval-first", action="store_true",
                   help="evaluate before the first epoch")
    p.add_argument("--eval-only", action="store_true",
                   help="no training: evaluate the checkpoint on the val "
                        "split")
    p.add_argument("--device-prefetch", type=int, default=0,
                   metavar="DEPTH",
                   help="place the next DEPTH batches on the card from a "
                        "producer thread")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="keep an EMA of the parameters and evaluate with it")
    p.add_argument("--opt-state-dtype", default=None,
                   choices=["bfloat16", "float32"],
                   help="storage dtype of the optimizer state")
    p.add_argument("--executable-cache", default=None, metavar="DIR",
                   help="executable cache dir (core/excache.py; env "
                        "DVT_EXCACHE): the compiled libraries (CUDA "
                        "kernels, record reader) load from this "
                        "content-addressed store, and a miss is compiled "
                        "into it, so a restarted process pays no compiler")
    p.add_argument("--tensorboard-dir", default=None)
    p.add_argument("--metrics-export", default=None, metavar="PATH",
                   help="write the metrics registry as Prometheus text "
                        "exposition format at the end of the run")
    p.add_argument("--telemetry-sample-every", type=int, default=16,
                   help="stream-synchronize fence cadence for the "
                        "step-time breakdown (obs/stepclock.py)")
    p.add_argument("--telemetry-port", type=int, default=None,
                   metavar="PORT",
                   help="serve live /metrics /varz /healthz /statusz "
                        "/alertz over HTTP on PORT (0: a free port, "
                        "journaled as a telemetry_server event and written "
                        "to a discovery file under the checkpoint dir for "
                        "deep_vision_tpu_torch.tools.obs_poll); env "
                        "DVT_TELEMETRY (obs/telemetry.py)")
    p.add_argument("--summary", action="store_true",
                   help="print the per-parameter model summary table "
                        "(torchsummary analog) before training")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (default: the card)")
    return p


def _make_excache(args, journal):
    """--executable-cache, else DVT_EXCACHE: the ExecutableCache the run
    attaches, journaling to the run's journal; None without either."""
    if not args.executable_cache:
        args.executable_cache = knobs.get_str("DVT_EXCACHE")
    if not args.executable_cache:
        return None
    from deep_vision_tpu_torch.core.excache import ExecutableCache

    return ExecutableCache(args.executable_cache, journal=journal)


def main(argv: Optional[List[str]] = None) -> int:
    """Train, resume or evaluate one config; returns 0, or
    REQUEUE_EXIT_CODE (75) after a preemption whose save ran."""
    from deep_vision_tpu_torch.obs import flight as flight_mod
    from deep_vision_tpu_torch.obs import locksmith

    parser = make_parser()
    args = parser.parse_args(argv)
    # the requeue latch is process-wide, and main may run more than once
    # in a process: this run's verdict starts clean
    flight_mod.clear_requeue()
    determinism = _deterministic()
    device = resolve_device(args.device)
    cfg = get_config(args.model)
    if args.epochs is not None:
        cfg.epochs = args.epochs
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    print(f"precision: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"(PyTorch's defaults); deterministic {determinism}; device "
          f"{device}", flush=True)
    train_fn, eval_fn = build_dataloaders(
        cfg, args.data_dir, args.fake_data, args.fake_batches,
        args.num_workers, preprocessing=args.preprocessing,
        num_procs=args.num_procs)
    ckpt_dir = args.ckpt_dir or os.path.join("checkpoints", cfg.name)
    # the discovery files go to the run's dir, not a resume's
    run_dir = ckpt_dir
    if args.checkpoint and args.checkpoint != "auto":
        ckpt_dir = args.checkpoint  # saves follow the resume dir
    if cfg.task in GAN_TASKS:
        return gan_main(parser, args, cfg, train_fn, ckpt_dir, device,
                        run_dir)
    journal = _make_journal(args, cfg)
    # DVT_LOCKSMITH arms the lock sanitizer for this run (journal-less
    # too: its findings then count in report() only)
    sanitizer = locksmith.arm_from_env(journal=journal)
    tracer = _make_tracer(args, journal)
    health = _make_health(args, journal)
    flight = _make_flight(args, journal)
    telemetry = _make_telemetry(args, journal, flight, run_dir)
    data_loader = None
    if args.data_snapshot:
        cand = train_fn()
        if getattr(cand, "snapshot_supported", lambda: False)():
            data_loader = cand
        else:
            parser.error(
                "--data-snapshot needs a snapshot-capable DataLoader: a real "
                "dataset (not --fake-data) with --num-procs 0")
    trainer = build_trainer(
        cfg, train_fn, ckpt_dir, ema_decay=args.ema_decay, journal=journal,
        health=health, device_prefetch=args.device_prefetch,
        opt_state_dtype=(None if args.opt_state_dtype == "float32"
                         else args.opt_state_dtype),
        data_loader=data_loader, device=device,
        executable_cache=_make_excache(args, journal),
        tb_dir=args.tensorboard_dir,
        telemetry_sample_every=args.telemetry_sample_every,
        telemetry=telemetry)
    try:
        _train_or_evaluate(args, cfg, trainer, train_fn, eval_fn, journal)
    finally:
        if trainer.logger.tb is not None:
            trainer.logger.tb.close()
    _finish(device, journal, tracer=tracer, flight=flight,
            sanitizer=sanitizer, metrics_export=args.metrics_export,
            telemetry=telemetry)
    return _exit_code()


def _train_or_evaluate(args, cfg: ExperimentConfig, trainer, train_fn,
                       eval_fn, journal) -> None:
    """main's run of a built Trainer: the parameter count (and with
    --summary the table), the resume, then training or --eval-only."""
    from deep_vision_tpu_torch.core.summary import count_params, model_summary

    if journal is not None:
        journal.add_closer(trainer.close)
    if args.summary:
        # the module build_trainer built, not a rebuild
        print(model_summary(trainer.model, torch.ones(
            (2, *model_input_shape(cfg)), dtype=torch.float32)), flush=True)
    print(f"model {cfg.model}: {count_params(trainer.model):,} trainable "
          f"params", flush=True)
    start_epoch = 0
    if args.checkpoint:
        start_epoch = trainer.resume()
        print(f"resumed from step {trainer.state.step} -> epoch "
              f"{start_epoch}", flush=True)
    if args.eval_only:
        run_eval_only(cfg, trainer, eval_fn)
    else:
        trainer.fit(train_fn, eval_fn, epochs=cfg.epochs,
                    start_epoch=start_epoch, eval_first=args.eval_first)
    trainer.close()


def _exit_code() -> int:
    """REQUEUE_EXIT_CODE after a preemption whose save ran, else 0."""
    from deep_vision_tpu_torch.obs import flight as flight_mod

    return (flight_mod.REQUEUE_EXIT_CODE if flight_mod.requeue_requested()
            else 0)


def _finish(device: torch.device, journal, tracer=None, flight=None,
            sanitizer=None, metrics_export: Optional[str] = None,
            telemetry=None) -> None:
    """Close the telemetry server first (no scrape reads what the rest
    tears down); print (and journal) the peak device memory; close the
    tracer (its file is written), disarm this run's lock sanitizer (its
    queued rows reach the journal), write the metrics registry to
    `metrics_export` (Prometheus text), close the journal, and disarm
    the flight recorder: a clean exit leaves no bundle."""
    from deep_vision_tpu_torch.obs import locksmith

    if telemetry is not None:
        telemetry.close()

    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        print(f"peak device memory: {peak} bytes "
              f"(torch.cuda.max_memory_allocated)", flush=True)
        if journal is not None:
            journal.write("note", note="peak_memory", bytes=int(peak))
    if tracer is not None:
        from deep_vision_tpu_torch.obs.trace import set_tracer

        tracer.close()
        set_tracer(None)
        print(f"trace written to {tracer.path} (load in Perfetto / "
              "chrome://tracing)", flush=True)
    if sanitizer is not None and locksmith.get_sanitizer() is sanitizer:
        locksmith.disarm()
    if metrics_export:
        from deep_vision_tpu_torch.obs.registry import get_registry

        if get_registry().write_prometheus(metrics_export):
            print(f"metrics exported to {metrics_export}", flush=True)
    if journal is not None:
        journal.close()
    if flight is not None:
        flight.close()


def gan_main(parser, args, cfg: ExperimentConfig, train_fn, ckpt_dir: str,
             device: torch.device, run_dir: str) -> int:
    """The reference's GAN branch of main (train_cli.py:1110-1265): the
    G/D parameter counts, restore-or-initialize from `-c`, then epochs
    of steps under a PreemptionGuard, each epoch's mean metrics printed,
    journaled and checked by the health monitor, a checkpoint every
    epoch (DCGAN, the newest 3 kept) or every 2 (CycleGAN). On SIGTERM
    the state is saved at the next step boundary, marked so that a
    resume re-runs the interrupted epoch, and the run ends with the
    requeue code (75).
    Every step journals the trainer's StepClock row (its timing, the
    first sub-network's optimizer step, the epoch, its images and that
    sub-network's learning rate); the metrics stay on the device until
    the epoch ends. --summary prints G's and D's tables. With
    --telemetry-port the live server registers the health monitor as
    its `train` health source, and nothing else, as the reference's GAN
    branch does; its discovery file goes to `run_dir`."""
    from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
    from deep_vision_tpu_torch.core.summary import count_params, model_summary
    from deep_vision_tpu_torch.obs import flight as flight_mod
    from deep_vision_tpu_torch.obs import locksmith
    from deep_vision_tpu_torch.parallel.multihost import PreemptionGuard

    if args.eval_only:
        parser.error(f"--eval-only is not supported for GAN task "
                     f"{cfg.task!r} (no scalar quality metric; use the "
                     f"sample grids instead)")
    if args.data_snapshot:
        parser.error(f"--data-snapshot rides the standard Trainer "
                     f"checkpoint/resume path; GAN task {cfg.task!r} has its "
                     f"own loop without it")
    journal = _make_journal(args, cfg)
    sanitizer = locksmith.arm_from_env(journal=journal)
    tracer = _make_tracer(args, journal)
    health = _make_health(args, journal)
    flight = _make_flight(args, journal)
    telemetry = _make_telemetry(args, journal, flight, run_dir)
    if telemetry is not None and health is not None:
        telemetry.add_health("train", health.healthz)
    excache = _make_excache(args, journal)
    if excache is not None:
        from deep_vision_tpu_torch.core import build

        build.attach_cache(excache)
    trainer = build_gan_trainer(
        cfg, health=health, device=device, journal=journal,
        telemetry_sample_every=args.telemetry_sample_every)
    names = ({"G": "g", "D": "d"} if cfg.task == "dcgan" else
             {"G_ab": "gab", "G_ba": "gba", "D_a": "da", "D_b": "db"})
    states = trainer.states()
    print(f"model {cfg.model}: " + " ".join(
        f"{k}={count_params(states[v].model):,}" for k, v in names.items())
        + " trainable params", flush=True)
    if args.summary:
        img = torch.ones((2, *cfg.input_shape), dtype=torch.float32)
        if cfg.task == "dcgan":
            parts = {"G": (trainer.g_state,
                           torch.ones((2, trainer.latent_dim))),
                     "D": (trainer.d_state, img)}
        else:
            parts = {"G": (trainer.gab, img), "D": (trainer.da, img)}
        for k, (state, sample) in parts.items():
            print(f"-- {k} --")
            print(model_summary(state.model, sample), flush=True)
    save_every = 2 if cfg.task == "cyclegan" else 1
    ckpt = CheckpointManager(ckpt_dir,
                             max_to_keep=3 if cfg.task == "dcgan" else None,
                             journal=journal)
    start_epoch = 0
    if args.checkpoint:
        start_epoch = trainer.restore(ckpt)
        if start_epoch:
            print(f"resumed GAN training at epoch {start_epoch}",
                  flush=True)
    first = next(iter(states.values()))
    if health is not None:
        health.start_watchdog()  # no-op without --watchdog-timeout
    with PreemptionGuard() as guard:
        for epoch in range(start_epoch, cfg.epochs):
            collected: list = []
            interrupted = False
            for batch_i, batch in enumerate(
                    trainer.clock.iter_data(train_fn())):
                if guard.agreed(step=batch_i):
                    interrupted = True
                    break
                images = batch["image"]
                extra = dict(epoch=epoch, examples=len(images),
                             lr=first.optimizer.param_groups[0]["lr"])
                if cfg.task == "dcgan":
                    metrics = trainer.train_step(images, extra=extra)
                else:
                    half = len(images) // 2 or 1
                    metrics = trainer.train_step(images[:half],
                                                 images[half:half * 2],
                                                 extra=extra)
                collected.append(metrics)
            if collected and not interrupted:
                summary = {k: sum(float(m[k]) for m in collected)
                           / len(collected) for k in sorted(collected[0])}
                print(f"epoch {epoch}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in summary.items()), flush=True)
                if journal is not None:
                    journal.write("epoch", name="gan", epoch=epoch,
                                  summary=summary)
                if health is not None:
                    health.check_summary(epoch, summary)
            if guard.agreed(force=True):
                done = epoch if not interrupted else epoch - 1
                saved = trainer.save(ckpt, epoch, completed_epoch=done)
                ckpt.wait()
                print(f"preempted in epoch {epoch}: "
                      + ("checkpoint written" if saved
                         else "checkpoint DECLINED (nothing new to save)"),
                      flush=True)
                if journal is not None:
                    journal.write("preempt_checkpoint",
                                  step=int(ckpt.latest_step() or 0),
                                  epoch=epoch, saved=bool(saved),
                                  dir=ckpt_dir)
                flight_mod.request_requeue()
                break
            if (epoch + 1) % save_every == 0:
                trainer.save(ckpt, epoch)
    ckpt.wait()
    if telemetry is not None:
        telemetry.close()  # first: no scrape reads a stopped monitor
    if health is not None:
        health.stop()
    _finish(device, journal, tracer=tracer, flight=flight,
            sanitizer=sanitizer, metrics_export=args.metrics_export)
    return _exit_code()


if __name__ == "__main__":
    raise SystemExit(main())
