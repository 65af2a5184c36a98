"""The Trainer, the port of deep_vision_tpu/train/trainer.py.

One model, one optimizer and one loss on one device: `train_step`
follows `_train_step_impl` (trainer.py:589-627): the model runs in
training mode on `batch[input_key]` (BatchNorm normalises with batch
statistics and updates its running ones), `loss_fn(outputs, batch)`
gives `(loss, metrics)`, the gradients of the loss update the
parameters, and the metrics gain `grad_norm`, the global L2 norm of the
gradients. As on one device in the reference (`_pad_and_mask`), every
batch gets a `_mask` of ones unless it has one, so the loss takes its
weighted path.

Dropout draws a step's masks from a generator on the device seeded from
the Trainer's checkpointed generator and the step
(`dropout_step_seed(state.generator.initial_seed(), step)`), as the
reference draws them from `fold_in(state.rng, state.step)`
(trainer.py:590-602): a resumed run draws the same masks as a straight
one, and a skipped step's retry the same as the skip. Evaluation (the
EMA's `functional_call` included) runs in eval mode, without dropout.

A learning-rate schedule (`lr_schedule`, by default the optimizer
spec's own when `build_optimizer` was given one) sets every parameter
group's lr to `lr_schedule(step)` before each update, where `step`
counts the updates taken so far: the count optax's `inject_hyperparams`
evaluates the reference's schedule at. A `plateau`
(ReduceLROnPlateau) instead scales the **base** learning rate, read
from the optimizer as built, after each epoch's evaluation
(trainer.py:1362-1370); a resume never reads the base back from a
restored, already scaled group. A schedule and a plateau together are
refused (trainer.py:300-320).

The epoch loop `fit` follows trainer.py:891-993 and `_run_epoch`,
`_single_step_and_log` and `_post_epoch` follow :1158-1250 and
:1313-1373. Each step runs inside a StepClock record (obs/stepclock.py,
`self.clock`, on the Trainer's registry and journal, its fence every
`telemetry_sample_every` steps): `_run_epoch` iterates
`clock.iter_data` around the prefetcher, so the data wait is the wait
for a batch; the with-block issues the step (dispatch_ms) and, on a
sampled step, synchronizes the step's stream (sync_ms). Then the host
reads the step's metrics once (as the reference floats them for its
loggers), and only then commits the record: the reference's blocking
fetch there is `int(state.step)`, the port's step is a host int, and
the `float()` is what waits for the device, so step_time_ms covers the
device's work of the step on every step, sampled or not. The commit
writes the journal's one `step` row a step: StepClock's fields,
`metrics` {loss, lr}, and the port's epoch, examples, lr, loss,
grad_norm and skipped. The read metrics then go to the train
`MetricLogger` (with the clock's data wait and rate), the health monitor
and the preemption poll. Under the skip_step health policy `train_step`
reads the finiteness flag on the host, so there dispatch_ms includes
the device's step. Each epoch ends with the divergence check (a
non-finite mean loss raises FloatingPointError unless an explicit warn
policy relaxes it),
`evaluate` (the val logger and a journal `eval` event), the plateau and
the save cadence. Checkpoints (`_save_checkpoint`, `resume`,
`_resume_data_state`, :994-1026, :1375-1464) carry the model, the
optimizer, the step and the generator through core/checkpoint.py, and
the loggers, the plateau and (with a snapshot-capable `data_loader`)
the DataLoader's position in the sidecar. With `ema_decay`, a float32
shadow of the parameters (train/ema.py) is updated after every step,
evaluation runs the shadow parameters with the live BatchNorm running
statistics through `torch.func.functional_call` (the training model is
never swapped), and the shadow is saved by a sibling manager under
`<ckpt>/ema`. `fit(handle_preemption=True)` installs a
parallel/multihost.py PreemptionGuard: on SIGTERM the step in flight
finishes, the state is saved (`_preempt_save`), the run is marked for
requeue (obs/flight.py `request_requeue`, which train_cli turns into
exit code 75) and fit returns. `close()` flushes the loggers'
TensorBoard writers (their owner closes them).

Spans (obs/trace.py, no-ops without an installed Tracer): `train/epoch`
around each epoch's steps, `train/step` around each step's issue, its
metrics' read and the clock's commit (with `step` in its args), `eval`,
`checkpoint/save` and `checkpoint/restore`. A span brackets host time
only: on the card a step's span is the time the host took to issue it
and to wait for its metrics.

The non-finite skip (health policy `skip_step`, trainer.py:614-627)
keeps the whole pre-step state when the loss or the gradient norm is
not finite: parameters, optimizer moments, the step counter and the
BatchNorm running statistics. The forward updates the running
statistics, so they are copied before it; the parameters and moments
are kept by not taking the optimizer step at all. The port's step
counter is a host int that drives the schedule, so the host must know
the flag before it sets the next learning rate: with the policy on,
`train_step` reads the finiteness flag once a step (a host sync between
the backward and the update). The alternative, a counter kept on the
device with a masked update, would leave the schedule and the step
count that `fit` logs to the device too; the loop reads every step's
metrics on the host anyway. Without the policy the step has no host
sync.

Device prefetch (`device_prefetch=N`, the reference's `_run_epoch` and
`_place_one`): `fit` runs each epoch's host batches through a
`data.DevicePrefetcher`, whose producer thread places up to N batches
ahead of the step. On the card `_place_one` pins each array, copies it
on the Trainer's one copy stream and records an event there;
`train_step` makes its own stream wait on that event before the step
and marks every placed tensor as used by that stream (`record_stream`),
so the caching allocator does not hand the memory back to the copy
stream while the step still reads it. A missed wait would read a batch
that is still being copied, silently. With a `data_loader`, a
mid-epoch snapshot counts up to N batches in flight as consumed;
epoch-boundary saves are exact.

`executable_cache=` (core/excache.py) attaches the cache to the
process (core/build.py `attach_cache`): the libraries the step loads
(the CUDA kernels, the record reader) come from it, and a miss is
compiled into it. The reference caches its compiled step executables
there; the port compiles no step, so the step itself is unchanged.

`telemetry=` (an obs/telemetry.py TelemetryServer) registers the
Trainer's live sources: the `train` status (the last step, epoch and
examples/s, from a host mirror the step loop writes after each commit,
so a scrape never reads a tensor), the `perf` status through
obs/perfwatch.py (StepClock's step-time p50/p95, the compiler runs),
and, with a HealthMonitor, the `train` health source. The reference's
`goodput` status, its alert engine and its `rendezvous` health source
wait for their planes (goodput and alerts, elastic training).

Not ported yet, and refused by the constructor when set: meshes and
sharding rules, multistep supersteps, profiler windows (`profile_dir`,
`autoprof`), checkify, and the backend and host supervisors.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch
from torch import nn

from deep_vision_tpu_torch.core import build
from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device
from deep_vision_tpu_torch.core.metrics import MetricLogger
from deep_vision_tpu_torch.core.train_state import create_train_state
from deep_vision_tpu_torch.data.device_prefetch import (
    DevicePrefetcher,
    PlacedBatch,
)
from deep_vision_tpu_torch.nn.layers import Dropout
from deep_vision_tpu_torch.obs import flight, perfwatch
from deep_vision_tpu_torch.obs.registry import get_registry
from deep_vision_tpu_torch.obs.stepclock import StepClock
from deep_vision_tpu_torch.obs.trace import span
from deep_vision_tpu_torch.parallel.multihost import PreemptionGuard
from deep_vision_tpu_torch.train.ema import EmaParams
from deep_vision_tpu_torch.train.optimizers import set_lr


#: the MetricLogger summary's wall-clock fields, left out of fit's history
_WALL_CLOCK = ("examples_per_sec", "epoch_time_s")


def _means(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in _WALL_CLOCK}


_MASK64 = 2 ** 64 - 1


def dropout_step_seed(base: int, step: int) -> int:
    """A step's dropout seed: splitmix64 of `base` advanced by `step + 1`
    golden-ratio increments. Distinct steps give unrelated seeds, and the
    same (base, step) the same seed in any process."""
    z = (base + (step + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class Trainer:
    """loss_fn(outputs, batch) -> (loss, metrics dict). `tx` builds the
    optimizer from the model (`train.optimizers.build_optimizer`);
    `lr_schedule` (step -> lr) defaults to its `schedule`, if any;
    `device_prefetch` > 0 places that many batches ahead in `fit`;
    `telemetry_sample_every` is the StepClock's fence cadence."""

    def __init__(self, model: nn.Module,
                 tx: Callable[[nn.Module], torch.optim.Optimizer],
                 loss_fn: Callable, sample_input,
                 eval_loss_fn: Optional[Callable] = None,
                 input_key: str = "image", device: DeviceLike = None,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 device_prefetch: int = 0, *,
                 checkpoint_manager=None, plateau=None,
                 plateau_metric: str = "top1",
                 logger: Optional[MetricLogger] = None,
                 eval_logger: Optional[MetricLogger] = None,
                 ema_decay: Optional[float] = None, journal=None,
                 registry=None, health=None, data_loader=None,
                 mesh=None, rng=None, profile_dir=None,
                 checkify_errors: bool = False, autoprof=None,
                 multistep: int = 1, backend_supervisor=None,
                 host_supervisor=None, executable_cache=None,
                 sharding_rules=None, telemetry=None,
                 telemetry_sample_every: int = 16):
        unported = [k for k, v in dict(
            mesh=mesh, rng=rng, profile_dir=profile_dir, autoprof=autoprof,
            backend_supervisor=backend_supervisor,
            host_supervisor=host_supervisor,
            sharding_rules=sharding_rules).items()
            if v is not None]
        unported += ["checkify_errors"] if checkify_errors else []
        unported += ["multistep"] if multistep != 1 else []
        if unported:
            raise NotImplementedError(
                f"Trainer({', '.join(unported)}): not ported yet")
        self.device = resolve_device(device)
        # one cache a process: attaching another root raises here
        self.excache = (build.attach_cache(executable_cache)
                        if executable_cache is not None else None)
        self.lr_schedule = lr_schedule or getattr(tx, "schedule", None)
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn or loss_fn
        self.input_key = input_key
        self.ckpt = checkpoint_manager
        self.plateau = plateau
        self.plateau_metric = plateau_metric
        self.journal = journal
        self.registry = registry or get_registry()
        # the step-time breakdown, its registry families and the
        # journal's step rows
        self.clock = StepClock(registry=self.registry, journal=journal,
                               name="train",
                               sample_every=telemetry_sample_every)
        self.health = health
        self._skip_nonfinite = bool(health is not None
                                    and health.skip_nonfinite)
        self.logger = logger or MetricLogger(
            name="train", registry=self.registry, journal=journal)
        # no journal on the val logger: evaluate() writes the `eval` event
        self.eval_logger = eval_logger or MetricLogger(
            name="val", print_every=0, registry=self.registry)
        self.data_loader = data_loader
        if data_loader is not None and hasattr(data_loader,
                                               "enable_snapshots"):
            # armed before the first epoch, so mid-epoch (preempt) saves
            # capture an exact position
            data_loader.enable_snapshots()
        self.state = create_train_state(model, tx, sample_input,
                                        device=self.device)
        self._dropouts = [m for m in model.modules()
                          if isinstance(m, Dropout)]
        self._dropout_gen = (torch.Generator(device=self.device)
                             if self._dropouts else None)
        # the base LR the plateau scales: the optimizer's as built, never
        # a restored (already scaled) group's
        self._base_lr = float(self.state.optimizer.param_groups[0]["lr"])
        if self.plateau is not None and self.lr_schedule is not None:
            raise ValueError(
                "plateau scaling requires a constant base learning rate: "
                "the optimizer's learning_rate is a schedule, which is "
                "re-evaluated before every step and would override plateau "
                "writes — use one LR policy")
        self.ema = None
        self._ema_ckpt = None
        if ema_decay is not None:
            self.ema = EmaParams(self.model, decay=ema_decay)
            if self.ckpt is not None:
                self._ema_ckpt = type(self.ckpt)(
                    os.path.join(self.ckpt.directory, "ema"),
                    journal=journal)
        self._buffer_snapshot: Optional[List[torch.Tensor]] = None
        self.prefetcher = (DevicePrefetcher(self._place_one,
                                            depth=device_prefetch)
                           if device_prefetch > 0 else None)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._pguard: Optional[PreemptionGuard] = None
        self._closed = False
        self.preempted = False
        # the live telemetry plane: host-side sources only. /statusz reads
        # the plain-Python mirror the step loop writes after each commit
        self._live_step: Optional[int] = None
        self._live_epoch: Optional[int] = None
        self._live_eps: Optional[float] = None
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.add_status("train", self._telemetry_status)
            perfwatch.set_quantile_source(self._step_time_quantiles)
            telemetry.add_status("perf", perfwatch.telemetry_status)
            if self.health is not None:
                telemetry.add_health("train", self.health.healthz)

    def _telemetry_status(self) -> dict:
        """The /statusz `train` source: the last step, epoch and
        examples/s the step loop published."""
        return {
            "step": self._live_step,
            "epoch": self._live_epoch,
            "examples_per_sec": (round(self._live_eps, 1)
                                 if self._live_eps else self._live_eps),
            "steps_seen": int(self.clock.steps_seen),
            "multistep": 1,
        }

    def _step_time_quantiles(self) -> dict:
        """Step-time p50/p95 for the /statusz `perf` source, at the
        StepClock histogram's bucket resolution ({} until a step lands)."""
        h = self.clock._h_step
        if not h.count:
            return {}

        def finite(v):
            return round(v, 3) if math.isfinite(v) else None

        return {"step_time_ms_p50": finite(h.quantile(0.5)),
                "step_time_ms_p95": finite(h.quantile(0.95))}

    @property
    def model(self) -> nn.Module:
        return self.state.model

    # -- batch placement ---------------------------------------------------
    def _pad_and_mask(self, batch: dict) -> dict:
        """The batch on the device, with a `_mask` of ones if it has none
        (one device: nothing to pad)."""
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
               for k, v in batch.items()}
        if "_mask" not in out:
            n = out[self.input_key].shape[0]
            out["_mask"] = torch.ones(n, dtype=torch.float32,
                                      device=self.device)
        return out

    def _place_one(self, batch: dict) -> PlacedBatch:
        """Host batch -> on the device with its `_mask`, off the step's
        stream: on the card, pinned and copied on `copy_stream`, with the
        event `ready` recorded after the copies."""
        n = self._rows(batch)
        if self.device.type != "cuda":
            return PlacedBatch(self._pad_and_mask(batch), n)
        stream = self.copy_stream
        with torch.cuda.stream(stream):
            data = {k: torch.as_tensor(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            if "_mask" not in data:
                data["_mask"] = torch.ones(len(data[self.input_key]),
                                           dtype=torch.float32,
                                           device=self.device)
            ready = torch.cuda.Event()
            ready.record(stream)
        return PlacedBatch(data, n, ready=ready)

    def _on_device(self, batch: Union[dict, PlacedBatch]) -> dict:
        """The batch as the step reads it: a host batch placed on the
        step's stream (`_pad_and_mask`), or a placed one made safe to
        read there: the stream waits for its copies, and its tensors are
        marked as used by the stream."""
        if not isinstance(batch, PlacedBatch):
            return self._pad_and_mask(batch)
        if batch.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.ready)
            for t in batch.data.values():
                t.record_stream(stream)
        return batch.data

    def _rows(self, batch: Union[dict, PlacedBatch]) -> int:
        """Valid rows of a batch: a placed batch's `n`; a host batch's
        mask's sum, else its length."""
        if isinstance(batch, PlacedBatch):
            return batch.n
        if "_mask" in batch:
            return int(torch.as_tensor(batch["_mask"]).sum())
        return len(batch[self.input_key])

    # -- steps -------------------------------------------------------------
    def train_step(self, batch: Union[dict, PlacedBatch]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a host batch or a `PlacedBatch`; returns
        the metrics as device scalars. Under the skip_step policy a
        non-finite loss or gradient norm leaves the state as it was and
        the metrics carry `skipped` = 1."""
        batch = self._on_device(batch)
        model, opt = self.state.model, self.state.optimizer
        model.train()
        if self._skip_nonfinite:
            buffers = list(model.buffers())
            if self._buffer_snapshot is None:
                self._buffer_snapshot = [torch.empty_like(b)
                                         for b in buffers]
            if buffers:  # a model without buffers (lenet5) has none to keep
                torch._foreach_copy_(self._buffer_snapshot, buffers)
        if self._dropouts:
            self._dropout_gen.manual_seed(dropout_step_seed(
                self.state.generator.initial_seed(), self.state.step))
            for m in self._dropouts:
                m.generator = self._dropout_gen
        loss, metrics = self.loss_fn(model(batch[self.input_key]), batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        if self._skip_nonfinite:
            ok = torch.isfinite(metrics["grad_norm"])
            if "loss" in metrics:
                ok = ok & torch.isfinite(metrics["loss"])
            metrics["skipped"] = 1.0 - ok.float()
            if not bool(ok):  # the policy's one host read a step
                if self._buffer_snapshot:
                    torch._foreach_copy_(list(model.buffers()),
                                         self._buffer_snapshot)
                opt.zero_grad(set_to_none=True)
                return {k: v.detach() for k, v in metrics.items()}
        if self.lr_schedule is not None:
            set_lr(opt, self.lr_schedule(self.state.step))
        opt.step()
        self.state.step += 1
        if self.ema is not None:
            self.ema.update(model)
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(self, batch: Union[dict, PlacedBatch]
                  ) -> Dict[str, torch.Tensor]:
        """Metrics of one batch in eval mode; with EMA, through the
        shadow parameters and the live running statistics."""
        batch = self._on_device(batch)
        model = self.state.model
        model.eval()
        with torch.no_grad():
            x = batch[self.input_key]
            if self.ema is not None:
                out = torch.func.functional_call(model, self.ema.params,
                                                 (x,))
            else:
                out = model(x)
            _, metrics = self.eval_loss_fn(out, batch)
        return metrics

    def lr_at(self, step: int) -> float:
        """The learning rate the last update used (the groups' lr: set
        before each update by the schedule or the plateau); `step` is
        kept for the reference's signature."""
        return float(self.state.optimizer.param_groups[0]["lr"])

    @property
    def current_lr(self) -> float:
        return self.lr_at(self.state.step)

    def close(self) -> None:
        """Stop the watchdog and drain asynchronous saves; idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.health is not None:
            self.health.stop()
        for lg in (self.logger, self.eval_logger):
            if lg.tb is not None:
                lg.tb.flush()
        if self.ckpt is not None:
            self.ckpt.wait()
        if self._ema_ckpt is not None:
            self._ema_ckpt.wait()

    # -- evaluation --------------------------------------------------------
    def evaluate(self, eval_data: Iterable[dict], epoch: int = 0
                 ) -> Dict[str, float]:
        """The val logger's summary over `eval_data`, each batch weighted
        by its valid rows; a journal `eval` event. A SIGTERM during fit
        ends the pass early."""
        with span("eval", epoch=epoch):
            return self._evaluate(eval_data, epoch)

    def _evaluate(self, eval_data: Iterable[dict], epoch: int
                  ) -> Dict[str, float]:
        self.eval_logger.start_epoch()
        step = 0
        for batch in eval_data:
            if self.health is not None:
                self.health.beat()
            if self._pguard is not None and self._pguard.agreed(step=step):
                break  # the caller re-checks with force=True and saves
            n = self._rows(batch)
            metrics = self.eval_step(batch)
            self.eval_logger.log_step(step, metrics, batch_size=n,
                                      epoch=epoch)
            step += 1
        summary = self.eval_logger.end_epoch(epoch)
        if self.journal is not None:
            self.journal.write("eval", epoch=epoch, summary=summary)
        return summary

    # -- the epoch loop ----------------------------------------------------
    def fit(self, train_data_fn: Callable[[], Iterable[dict]],
            eval_data_fn: Optional[Callable[[], Iterable[dict]]] = None,
            epochs: int = 1, start_epoch: int = 0, eval_first: bool = False,
            save_every: int = 1, handle_preemption: bool = True,
            preemption_poll_every: int = 10) -> List[dict]:
        """Epochs `start_epoch` .. `epochs - 1` over `train_data_fn()`,
        each followed by `evaluate(eval_data_fn())` when given, the
        plateau and the save cadence. Returns one record per finished
        epoch: {"epoch", "train", "val"}, the train and val loggers'
        summaries without their wall-clock fields (examples_per_sec,
        epoch_time_s), which the loggers and the journal keep; after a
        preemption, the records up to it."""
        self._pguard = (PreemptionGuard(poll_every=preemption_poll_every)
                        if handle_preemption else None)
        self._closed = False
        self.preempted = False
        if self.health is not None:
            self.health.start_watchdog()  # no-op without a timeout
        history: List[dict] = []
        ctx = self._pguard or contextlib.nullcontext()
        try:
            with ctx:
                if eval_first and eval_data_fn is not None:
                    self.evaluate(eval_data_fn(), epoch=start_epoch)
                for epoch in range(start_epoch, epochs):
                    with span("train/epoch", epoch=epoch):
                        status, summary = self._run_epoch(train_data_fn,
                                                          epoch)
                    if status == "preempted":
                        return history
                    status, val = self._post_epoch(summary, eval_data_fn,
                                                   epoch, save_every)
                    if status == "preempted":
                        return history
                    record = {"epoch": epoch, "train": _means(summary)}
                    if eval_data_fn is not None:
                        record["val"] = _means(val)
                    history.append(record)
        finally:
            self._pguard = None
            if self.ckpt is not None:
                self.ckpt.wait()
            if self._ema_ckpt is not None:
                self._ema_ckpt.wait()
        return history

    def _run_epoch(self, train_data_fn, epoch: int):
        """One epoch of steps; returns ("preempted" | None, summary)."""
        self.logger.start_epoch()
        data = train_data_fn()
        if self.prefetcher is not None:
            data = self.prefetcher(data)
        for batch in self.clock.iter_data(data):
            if self._single_step_and_log(batch, epoch) == "preempted":
                # no end_epoch: the re-run epoch writes its own summary
                return "preempted", None
        return None, self.logger.end_epoch(epoch)

    def _single_step_and_log(self, batch, epoch: int):
        n = self._rows(batch)
        with span("train/step", epoch=epoch) as sp:
            with self.clock.step(batch_size=n, auto_commit=False) as rec:
                metrics = self.train_step(batch)
                rec.fence_on(metrics)
            opt_step = self.state.step
            lr = self.lr_at(opt_step)
            sp.set(step=opt_step)
            # the one host read for the record, the loggers and the
            # health monitor; it waits for the device, so it goes before
            # the commit, inside step_time_ms
            metrics_f = {k: float(v) for k, v in metrics.items()}
            loss_f = metrics_f.get("loss")
            grad_norm_f = metrics_f.get("grad_norm")
            skipped = (self._skip_nonfinite
                       and metrics_f.get("skipped", 0.0) > 0)
            rec.commit(step=opt_step,
                       metrics={"loss": loss_f, "lr": lr}
                       if "loss" in metrics_f else {"lr": lr},
                       extra=dict(epoch=epoch, examples=n, lr=lr,
                                  loss=loss_f, grad_norm=grad_norm_f,
                                  skipped=skipped))
        # the host mirror the telemetry scraper reads: plain attribute
        # writes, never a tensor
        self._live_step, self._live_epoch = opt_step, epoch
        self._live_eps = rec.examples_per_sec
        if skipped:
            # the discarded update's loss and gradients stay out of the
            # epoch means; the health event carries the record
            metrics_f = {k: v for k, v in metrics_f.items()
                         if math.isfinite(v)}
        self.logger.log_step(opt_step, metrics_f, batch_size=n, epoch=epoch,
                             lr=lr, data_wait_ms=rec.data_wait_ms,
                             examples_per_sec=rec.examples_per_sec)
        if self.health is not None:
            self.health.check_step(opt_step, loss=loss_f,
                                   grad_norm=grad_norm_f, skipped=skipped)
        if self._pguard is not None and self._pguard.agreed(step=opt_step):
            # epoch - 1: this epoch is incomplete, resume re-runs it
            self._preempt_save(epoch - 1)
            return "preempted"
        return None

    def _post_epoch(self, summary: dict, eval_data_fn, epoch: int,
                    save_every: int):
        """Divergence check, evaluation, plateau and save cadence;
        returns ("preempted" | None, the val summary)."""
        loss_avg = summary.get("loss")
        if loss_avg is not None and not math.isfinite(loss_avg):
            relax = (self.health is not None
                     and getattr(self.health, "policy_explicit", True)
                     and not self.health.skip_nonfinite
                     and self.health.policy != "abort")
            if relax:  # an explicit warn policy reports, never raises
                self.health.check_summary(epoch, {"loss": loss_avg})
            else:
                if self.ckpt is not None:
                    self.ckpt.wait()
                if self.journal is not None:
                    self.journal.write(
                        "note", note=f"diverged at epoch {epoch}: "
                                     f"mean loss {loss_avg}")
                if self.health is not None:
                    self.health.check_summary(epoch, {"loss": loss_avg})
                raise FloatingPointError(
                    f"training diverged: epoch {epoch} mean loss is "
                    f"{loss_avg}")
        # a SIGTERM after the last step: the epoch's training is complete
        if self._pguard is not None and self._pguard.agreed(force=True):
            self._preempt_save(epoch)
            return "preempted", None
        val_summary: dict = {}
        if eval_data_fn is not None:
            val_summary = self.evaluate(eval_data_fn(), epoch=epoch)
        if self._pguard is not None and self._pguard.agreed(force=True):
            self._preempt_save(epoch)
            return "preempted", None
        if self.plateau is not None and self.plateau_metric in val_summary:
            scale = self.plateau.step(val_summary[self.plateau_metric])
            set_lr(self.state.optimizer, self._base_lr * scale)
        if self.ckpt is not None and (epoch + 1) % save_every == 0:
            self._save_checkpoint(epoch, val_summary)
        return None, val_summary

    # -- checkpoints -------------------------------------------------------
    def _save_checkpoint(self, epoch: int, val_summary=None) -> bool:
        """Start an asynchronous save; journal `checkpoint` with save_ms,
        the time this call blocked the loop (the manager journals the
        write's own time when it lands)."""
        t0 = time.perf_counter()
        step = self.state.step
        with span("checkpoint/save", epoch=epoch, step=step):
            host_state = {
                "epoch": epoch,
                "train_logger": self.logger.state_dict(),
                "val_logger": self.eval_logger.state_dict(),
            }
            if self.plateau is not None:
                host_state["plateau"] = self.plateau.state_dict()
            if self.data_loader is not None:
                host_state["data_state"] = self.data_loader.state_dict()
            saved = self.ckpt.save(step, self.state, host_state=host_state,
                                   metrics=val_summary)
            if self._ema_ckpt is not None:
                self._ema_ckpt.save_tree(step, dict(self.ema.params),
                                         host_state=self.ema.state_dict())
        if self.journal is not None:
            self.journal.write("checkpoint", step=step, epoch=epoch,
                               saved=bool(saved),
                               save_ms=round((time.perf_counter() - t0)
                                             * 1e3, 3))
        return bool(saved)

    def _preempt_save(self, epoch: int) -> None:
        """After SIGTERM, at a step boundary: save synchronously, journal
        `preempt_checkpoint`, mark the run preempted and ask for the
        requeue exit code (obs/flight.py; the PreemptionGuard already
        dumped the `preempt` bundle)."""
        step = self.state.step
        self.preempted = True
        if self.ckpt is None:
            print(f"preempted at step {step}: NO checkpoint manager, "
                  "state not saved; exiting fit", flush=True)
            if self.journal is not None:
                self.journal.write("preempt_checkpoint", step=step,
                                   epoch=int(epoch), saved=False,
                                   reason="no checkpoint manager")
            flight.request_requeue()
            return
        saved = self._save_checkpoint(epoch)
        self.ckpt.wait()
        if self._ema_ckpt is not None:
            self._ema_ckpt.wait()
        if saved:
            print(f"preempted at step {step}: checkpoint written, "
                  "exiting fit", flush=True)
        else:
            print(f"preempted at step {step}: checkpoint manager DECLINED "
                  f"the save (latest on disk: {self.ckpt.latest_step()}); "
                  "exiting fit", flush=True)
        if self.journal is not None:
            self.journal.write("preempt_checkpoint", step=step,
                               epoch=int(epoch), saved=bool(saved),
                               dir=self.ckpt.directory)
        flight.request_requeue()

    def resume(self, step: Optional[int] = None) -> int:
        """Restore the state, the loggers, the plateau and the data
        position through the checkpoint's fallback chain; returns the
        next epoch to run (0 when nothing valid remains)."""
        assert self.ckpt is not None, "no CheckpointManager configured"
        t0 = time.perf_counter()
        with span("checkpoint/restore",
                  step=step if step is not None else -1):
            self.state, host_state = self.ckpt.restore(self.state, step)
        if self.journal is not None:
            self.journal.write(
                "note", note="resumed", step=self.state.step,
                host_state_found=host_state is not None,
                restore_ms=round((time.perf_counter() - t0) * 1e3, 3))
        if self.ema is not None:
            restored = ema_host = None
            if self._ema_ckpt is not None:
                # pinned to the step the main restore landed on: after a
                # fallback the EMA dir's newest may be a later step
                ema_step = step if step is not None else self.state.step
                try:
                    restored, ema_host = self._ema_ckpt.restore_tree(
                        dict(self.ema.params), ema_step)
                except Exception:
                    restored = ema_host = None
            if restored is not None:
                self.ema.params = restored
                self.ema.load_state_dict(ema_host or {})
            else:
                # no shadow for this step: seed from the restored weights
                self.ema = EmaParams(self.model, decay=self.ema.decay,
                                     warmup=self.ema.warmup)
        if not host_state:
            self._resume_data_state(None)
            return 0
        self.logger.load_state_dict(host_state.get("train_logger", {}))
        self.eval_logger.load_state_dict(host_state.get("val_logger", {}))
        if self.plateau is not None and "plateau" in host_state:
            self.plateau.load_state_dict(host_state["plateau"])
        self._resume_data_state(host_state.get("data_state"))
        return int(host_state.get("epoch", -1)) + 1

    def _resume_data_state(self, data_state) -> None:
        """Re-arm the DataLoader from the sidecar's position and journal
        `data_resume`: "restored" (the stream continues exactly) or
        "fresh" (the checkpoint carried none)."""
        if self.data_loader is None:
            return
        if data_state:
            info = self.data_loader.load_state_dict(data_state)
            if self.journal is not None:
                self.journal.write(
                    "data_resume", verdict="restored",
                    epoch=int(info["epoch"]), batches=int(info["batches"]),
                    shard=info.get("shard"), record=info.get("record"))
        elif self.journal is not None:
            self.journal.write("data_resume", verdict="fresh", epoch=0,
                               batches=0)
