"""Metrics: the port of deep_vision_tpu/core/metrics.py.

`topk_accuracy` is computed inside a step (:25-41). `MetricLogger`
(:63-158) is the host side: per-epoch meters weighted by batch size,
stdout lines with ISO timestamps, an examples/s meter (StepClock's rate
and data wait when the caller has a clock, obs/stepclock.py; else the
instantaneous rate), the epoch history that rides the checkpoint
sidecar (`state_dict`), TensorBoard scalars through a `tb_writer`
(core/tensorboard.py `SummaryWriter`: `{name}/batch_{k}`,
`{name}/examples_per_sec`, `{name}/data_wait_ms` a step and
`{name}/epoch_{k}` an epoch), and the fan-out of every step's metrics to
gauges of the port's obs/registry.py and of every epoch summary to the
journal's `epoch` event.
"""
from __future__ import annotations

import collections
import datetime
import time
from typing import Dict, Optional, Sequence

import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5),
                  weights: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Top-k accuracy fractions over int class ids `labels` (B,).
    `weights` (B,) masks padded rows. A stable descending sort orders
    tied logits by class index, as `jnp.argsort(-logits)` does."""
    maxk = max(ks)
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :maxk]
    correct = topk == labels[:, None]
    if weights is None:
        weights = torch.ones(labels.shape, dtype=logits.dtype,
                             device=logits.device)
    denom = torch.clamp_min(weights.sum(), 1e-9)
    return {f"top{k}": (correct[:, :k].any(dim=-1) * weights).sum() / denom
            for k in ks}


class _Meter:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, v, n=1):
        self.total += float(v) * n
        self.count += n

    @property
    def avg(self):
        return self.total / max(self.count, 1)


def _metric_slug(name: str) -> str:
    """Prometheus-safe metric name ('mAP@.5' -> 'mAP__5')."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


class MetricLogger:
    """Host-side metric series, stdout logging and examples/s meter.

    With `tb_writer`, every step's metrics and every epoch summary are
    also TensorBoard scalars; with `registry`/`journal`, every step's
    metrics also land as gauges and every epoch summary as a journal
    `epoch` event."""

    def __init__(self, tb_writer=None, print_every: int = 10,
                 name: str = "train", registry=None, journal=None):
        self.history: Dict[str, list] = collections.defaultdict(list)
        self.tb = tb_writer
        self.print_every = print_every
        self.name = name
        self.registry = registry
        self.journal = journal
        self._epoch_meters: Dict[str, _Meter] = {}
        self._epoch_start = time.time()
        self._epoch_examples = 0
        self._last_step_time: Optional[float] = None

    def start_epoch(self):
        self._epoch_meters = collections.defaultdict(_Meter)
        self._epoch_start = time.time()
        self._epoch_examples = 0
        self._last_step_time = None

    def log_step(self, step: int, metrics: dict, batch_size: int = 0,
                 epoch: Optional[int] = None, lr: Optional[float] = None,
                 data_wait_ms: Optional[float] = None,
                 examples_per_sec: Optional[float] = None):
        metrics = {k: float(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            self._epoch_meters[k].update(v, max(batch_size, 1))
        self._epoch_examples += batch_size
        # without a StepClock's rate: wall time since the previous
        # log_step
        now = time.time()
        if examples_per_sec is None and batch_size and \
                self._last_step_time is not None:
            dt = max(now - self._last_step_time, 1e-9)
            examples_per_sec = batch_size / dt
        self._last_step_time = now
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.scalar(f"{self.name}/batch_{k}", v, step)
            if examples_per_sec is not None:
                self.tb.scalar(f"{self.name}/examples_per_sec",
                               examples_per_sec, step)
            if data_wait_ms is not None:
                self.tb.scalar(f"{self.name}/data_wait_ms", data_wait_ms,
                               step)
        if self.registry is not None:
            for k, v in metrics.items():
                self.registry.gauge(
                    f"{self.name}_{_metric_slug(k)}").set(v)
            if lr is not None and lr == lr:  # skip NaN
                self.registry.gauge(f"{self.name}_learning_rate").set(lr)
        if self.print_every and step % self.print_every == 0:
            ts = datetime.datetime.now().isoformat(timespec="seconds")
            parts = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            lr_s = f" lr={lr:.2e}" if lr is not None else ""
            ep_s = f"epoch {epoch} " if epoch is not None else ""
            perf_s = ""
            if examples_per_sec is not None:
                perf_s += f" ex/s={examples_per_sec:.1f}"
            if data_wait_ms is not None:
                perf_s += f" data_wait_ms={data_wait_ms:.1f}"
            print(f"[{ts}] {self.name} {ep_s}step {step}: {parts}{lr_s}"
                  f"{perf_s}", flush=True)

    def end_epoch(self, epoch: int, extra: Optional[dict] = None) -> dict:
        """The epoch's summary (the meters' means, `extra`'s values, the
        examples/s and the seconds), into the history, TensorBoard, the
        registry and the journal, and printed."""
        elapsed = max(time.time() - self._epoch_start, 1e-9)
        summary = {k: m.avg for k, m in self._epoch_meters.items()}
        if extra:
            summary.update({k: float(v) for k, v in extra.items()})
        if self._epoch_examples:
            summary["examples_per_sec"] = self._epoch_examples / elapsed
        summary["epoch_time_s"] = elapsed
        for k, v in summary.items():
            self.history[k].append((epoch, v))
            if self.tb is not None:
                self.tb.scalar(f"{self.name}/epoch_{k}", v, epoch)
            if self.registry is not None:
                self.registry.gauge(
                    f"{self.name}_epoch_{_metric_slug(k)}").set(v)
        if self.journal is not None:
            self.journal.write("epoch", name=self.name, epoch=epoch,
                               summary=summary)
        ts = datetime.datetime.now().isoformat(timespec="seconds")
        parts = " ".join(f"{k}={v:.4f}" for k, v in summary.items())
        print(f"[{ts}] {self.name} epoch {epoch} done: {parts}", flush=True)
        return summary

    # -- persistence (the checkpoint sidecar) ------------------------------
    def state_dict(self) -> dict:
        return {"history": {k: v for k, v in self.history.items()}}

    def load_state_dict(self, d: dict):
        self.history = collections.defaultdict(list)
        for k, v in d.get("history", {}).items():
            self.history[k] = [tuple(x) for x in v]
