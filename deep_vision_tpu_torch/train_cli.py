"""The training CLI, the port of deep_vision_tpu/train_cli.py.

    python -m deep_vision_tpu_torch.train_cli -m resnet50 --data-dir D \\
        --ckpt-dir C [-c auto|DIR] [--epochs N] [--device cuda|cpu]

trains a registered config (configs/__init__.py) and evaluates it every
epoch. Classification reads ImageNet-layout records `D/tfrecord_train/*`
and `D/tfrecord_val/*` (the flattened-folder layout `D/train_flatten`,
`D/val_flatten` where no train records exist; MNIST idx files
`D/train-images-idx3-ubyte`, `D/train-labels-idx1-ubyte`,
`D/t10k-images-idx3-ubyte` and `D/t10k-labels-idx1-ubyte` for the
`mnist` kind of lenet5). Detection (`yolov3_coco`, `yolov3_voc`) reads
box records `D/train*` and `D/val*` in the config's schema, as
`python -m deep_vision_tpu_torch.tools.convert voc|coco` writes them.
`--fake-data` takes the reference's seeded fake batches instead. It
runs the config's optimizer, schedule or plateau, a checkpoint
with its crc32c sidecar after each epoch, a SIGTERM save at the next
step boundary (the process then exits 0), and `-c` resuming where the
checkpoint left off: parameters, momentum, BatchNorm running statistics,
the step counter, the plateau, the loggers and, with `--data-snapshot`,
the batch stream. `--eval-only` evaluates a checkpoint: loss and top-k
for classification; for detection, mAP@.5 and mAP@[.5:.95] over the
val split through the YOLO detector at score 0.1, whose NMS runs on the
card. It runs on the card unless `--device cpu` is given, and raises
without one.

Ported: `model_input_shape`, `_fake_classification`, `_fake_detection`,
`build_dataloaders` (fake, mnist, imagenet, and the records kind of the
detection task, with both `--preprocessing` chains and the s2d host
transform), `_steps_per_epoch`, `_build_schedule`, `build_trainer` and
`run_eval_only` for the classification and detection tasks, and `main`
with the flags below. Every other reference flag is unknown here, so
argparse fails on it loudly; the pose, centernet, dcgan and cyclegan
tasks, the GAN trainers and the requeue exit code after a preemption are
not ported yet. Every registered classification and detection config
trains.

Float32 precision: the CLI keeps PyTorch's defaults, which no registered
config overrides, and prints them at start-up: cuDNN convolutions may
use TF32 (`torch.backends.cudnn.allow_tf32`, True by default) and cuBLAS
matmuls do not (`torch.backends.cuda.matmul.allow_tf32`, False). On a
TPU float32 convolutions have no such switch; this is the port's choice.
`DVT_DETERMINISTIC=1` (core/knobs.py) runs under
`torch.use_deterministic_algorithms(True)` with cudnn.benchmark off and
CUBLAS_WORKSPACE_CONFIG=:4096:8 set before CUDA starts, so a run and its
resume repeat bitwise.
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


#: the fake-data makers of the ported tasks
FAKE_DATA = {"classification": _fake_classification,
             "detection": _fake_detection}


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
    `tfrecord_train` holds no shard), MNIST, or a detection config's box
    records, through the port's data layer."""
    if fake or cfg.dataset.get("kind") == "fake":
        if cfg.task not in FAKE_DATA:
            raise NotImplementedError(
                f"fake {cfg.task} data is not ported yet")
        data = FAKE_DATA[cfg.task](cfg, fake_batches)
        return (lambda: data), (lambda: data)
    kind = cfg.dataset["kind"]
    if kind == "records":
        return detection_dataloaders(cfg, data_dir, num_workers, num_procs)
    if kind not in ("imagenet", "mnist"):
        raise NotImplementedError(
            f"dataset kind {kind!r} is not ported yet (imagenet, mnist, "
            f"records and fake are)")
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


def detection_dataloaders(cfg: ExperimentConfig, data_dir: str,
                          num_workers: int, num_procs: int = 0):
    """The records kind for the detection task (train_cli.py:245-300):
    `train_glob` / `val_glob` (default train*, val*) under `data_dir` in
    the config's schema; the train chain flips, crops around the boxes,
    resizes to the input, scales to [0, 1] and pads the boxes to 100;
    the eval chain only resizes, scales and pads. Partial batches are
    dropped."""
    if cfg.task != "detection":
        raise NotImplementedError(
            f"the records kind for task {cfg.task!r} is not ported yet "
            f"(detection is)")
    from deep_vision_tpu_torch.data import Compose, DataLoader, RecordDataset
    from deep_vision_tpu_torch.data import transforms as T

    size = cfg.input_shape[0]
    schema = cfg.dataset["schema"]
    train_chain = [T.RandomHorizontalFlip(), T.RandomCropWithBoxes(),
                   T.Resize(size), T.ToFloat(), T.PadBoxes(100)]
    eval_chain = [T.Resize(size), T.ToFloat(), T.PadBoxes(100)]
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
                  device: DeviceLike = None):
    """The reference's build_trainer for the classification and detection
    tasks, on `device` (default cuda, raising without a card). Detection
    trains on `yolo_train_loss_fn` with the grids of the input size
    (s/32, s/16, s/8)."""
    from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
    from deep_vision_tpu_torch.core.metrics import MetricLogger
    from deep_vision_tpu_torch.losses import (
        classification_loss_fn,
        yolo_train_loss_fn,
    )
    from deep_vision_tpu_torch.obs.registry import get_registry
    from deep_vision_tpu_torch.train import Trainer, build_optimizer
    from deep_vision_tpu_torch.train.optimizers import ReduceLROnPlateau

    dev = resolve_device(device)
    if cfg.task not in ("classification", "detection"):
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (classification and "
            f"detection are)")
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
        loss_fn = functools.partial(classification_loss_fn,
                                    **cfg.loss_kwargs)
    plateau = ReduceLROnPlateau(**cfg.plateau) if cfg.plateau else None
    ckpt = CheckpointManager(ckpt_dir, journal=journal) if ckpt_dir else None
    sample = torch.ones((2, *model_input_shape(cfg)), dtype=torch.float32)
    logger = MetricLogger(name="train", registry=get_registry(),
                          journal=journal)
    eval_logger = MetricLogger(name="val", print_every=0,
                               registry=get_registry())
    return Trainer(model, tx, loss_fn, sample, device=dev,
                   lr_schedule=lr if callable(lr) else None,
                   device_prefetch=device_prefetch, plateau=plateau,
                   plateau_metric=cfg.plateau_metric,
                   checkpoint_manager=ckpt, logger=logger,
                   eval_logger=eval_logger, ema_decay=ema_decay,
                   journal=journal, health=health, data_loader=data_loader)


def run_eval_only(cfg: ExperimentConfig, trainer, eval_fn) -> dict:
    """Evaluate the (restored) state on the val split: classification
    loss and top-k; detection mAP@.5 and mAP@[.5:.95] from the YOLO
    detector (score 0.1, NMS on the trainer's device) and
    `DetectionEvaluator` (train_cli.py:469-507). Pose PCK is not ported
    yet."""
    if cfg.task == "classification":
        summary = trainer.evaluate(eval_fn())
        print("eval: " + " ".join(f"{k}={v:.4f}"
                                  for k, v in summary.items()))
        return summary
    if cfg.task != "detection":
        raise NotImplementedError(
            f"--eval-only for task {cfg.task!r} is not ported yet")
    from deep_vision_tpu_torch.core.detection_metrics import (
        DetectionEvaluator,
    )
    from deep_vision_tpu_torch.inference import make_yolo_detector

    model = trainer.model.eval()
    variables = dict(model.state_dict())
    detect = make_yolo_detector(model, device=trainer.device,
                                score_threshold=0.1)
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
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (default: the card)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
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
    if args.checkpoint and args.checkpoint != "auto":
        ckpt_dir = args.checkpoint  # saves follow the resume dir
    journal = _make_journal(args, cfg)
    health = _make_health(args, journal)
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
        data_loader=data_loader, device=device)
    if journal is not None:
        journal.add_closer(trainer.close)
    from deep_vision_tpu_torch.core.summary import count_params

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
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        print(f"peak device memory: {peak} bytes "
              f"(torch.cuda.max_memory_allocated)", flush=True)
        if journal is not None:
            journal.write("note", note="peak_memory", bytes=int(peak))
    if journal is not None:
        journal.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
