"""Step-time breakdown, compiler runs and device memory.

The port of deep_vision_tpu/obs/stepclock.py. A CUDA step is queued
asynchronously, so the wall time around a `train_step` call is the time
the host took to issue it, not the device's. StepClock separates:

  data_wait_ms   host blocked in the data iterator's next()
  dispatch_ms    host time inside the step's with-block (issue)
  step_time_ms   data wait + enter -> commit: with a deferred commit,
                 the caller's host read of the step's results between
                 the with-block and `commit()` is inside it, and with it
                 the device's time of the step
  sync_ms        on sampled steps only: the step's stream synchronized
                 at the end of the with-block

The fence runs every `sample_every` steps (default 16). It synchronizes
`torch.cuda.current_stream(device)` of the first CUDA tensor handed to
`fence_on`, never the whole device, and is a no-op for CPU tensors (its
sync_ms is then the cost of the check).

Compiles: the reference counts XLA backend compiles from a
jax.monitoring listener. The port compiles no step: its compilers are
nvcc and g++ (core/build.py), so `recompile_count()` is
`build.build_count()` and `compile_seconds()` is
`build.compile_seconds()`. Device memory is
`torch.cuda.memory_allocated` / `max_memory_allocated` of the step's
device; on the CPU `hbm_stats` gives (None, None), as the reference does
on a backend without memory stats.

The registry families, the sampling cadence, the `auto_commit=False` /
`commit()` contract and the journal's `step` fields are the
reference's, so tools/check_journal.py and tools/obs_report.py read the
port's rows as they read the reference's.
"""
from __future__ import annotations

import sys
import time
from typing import Iterable, Iterator, Optional

from deep_vision_tpu_torch.core import build
from deep_vision_tpu_torch.obs.registry import Registry, get_registry


def recompile_count() -> int:
    """Compiler runs this process has started (nvcc and g++)."""
    return build.build_count()


def compile_seconds() -> float:
    """Seconds this process's compiler runs took (core/build.py). Each
    step row carries the increase since the previous committed step as
    `compile_ms`."""
    return build.compile_seconds()


def _default_device():
    """The current CUDA device when this process has initialised CUDA,
    else None (a CPU-only process never initialises it here)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def hbm_stats(device=None) -> "tuple[Optional[int], Optional[int]]":
    """(bytes allocated, peak bytes allocated) of one CUDA device, from
    PyTorch's caching allocator: `torch.cuda.memory_allocated` and
    `max_memory_allocated`, read from one nested statistics dict (each of
    those builds and flattens the whole dict, ~0.1 ms on the card's
    host). (None, None) for the CPU; `device` None: the current CUDA
    device when CUDA is initialised, else (None, None)."""
    if device is None:
        device = _default_device()
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return None, None
    import torch

    allocated = torch.cuda.memory_stats_as_nested_dict(device)[
        "allocated_bytes"]["all"]
    return int(allocated["current"]), int(allocated["peak"])


def hbm_bytes_in_use(device=None) -> Optional[int]:
    """Device bytes allocated, or None on the CPU."""
    return hbm_stats(device)[0]


def _device_of(out):
    """The device a step's output lives on: that of the first CUDA
    tensor in `out` (a tensor, or a dict, list or tuple of them), else
    the CPU when `out` holds a tensor, else None."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, dict):
        out = list(out.values())
    found = None
    if isinstance(out, (list, tuple)):
        for v in out:
            dev = _device_of(v)
            if dev is not None and dev.type == "cuda":
                return dev
            found = found or dev
    return found


class StepClock:
    """Per-step timing around a host training loop.

    Usage (what Trainer._run_epoch does):

        for batch in clock.iter_data(data):        # times next()
            with clock.step(batch_size=n, auto_commit=False) as rec:
                out = train_step(batch)
                rec.fence_on(out)                  # sampled stream sync
            host = {k: float(v) for k, v in out.items()}
            rec.commit(step=..., metrics=...)      # the journal's row

    All timing is host-side perf_counter; the only device interaction is
    the sampled fence and the memory read beside it."""

    def __init__(self, registry: Optional[Registry] = None,
                 journal=None, name: str = "train",
                 sample_every: int = 16):
        self.registry = registry or get_registry()
        self.journal = journal
        self.name = name
        self.sample_every = max(1, int(sample_every))
        self._steps_seen = 0
        self._sync_samples = 0
        self._last_data_wait_ms = 0.0
        # compile seconds at construction: a step row carries the
        # increase since the previous committed step, so a clock built
        # after another run's builds never attributes them
        self._compile_s_last = compile_seconds()

        r = self.registry
        self._g_data_wait = r.gauge(f"{name}_data_wait_ms",
                                    "host ms blocked on the data iterator")
        self._g_step = r.gauge(f"{name}_step_time_ms",
                               "wall ms per step (wait + issue + read)")
        self._g_eps = r.gauge(f"{name}_examples_per_sec",
                              "wall-clock examples/sec")
        self._g_recompiles = r.gauge(
            "jit_recompiles_total",
            "compiler runs this process (nvcc, g++; core/build.py)")
        self._g_hbm = r.gauge("hbm_bytes_in_use",
                              "device bytes allocated (0 where unavailable)")
        self._g_hbm_peak = r.gauge(
            "hbm_peak_bytes_in_use",
            "device peak bytes allocated (0 where unavailable)")
        self._h_step = r.histogram(f"{name}_step_ms",
                                   "per-step wall ms distribution")
        self._h_wait = r.histogram(f"{name}_data_wait_ms_hist",
                                   "per-step data-wait ms distribution")
        self._c_steps = r.counter(f"{name}_steps_total", "steps executed")
        self._c_examples = r.counter(f"{name}_examples_total",
                                     "examples consumed")
        self._c_starved = r.counter(
            f"{name}_data_starved_steps_total",
            "steps whose data wait exceeded their dispatch time")

    # -- data-wait side ----------------------------------------------------

    def iter_data(self, data: Iterable) -> Iterator:
        """Wrap a batch iterable, timing each next() as data wait. Around
        a DevicePrefetcher, next() waits only until a placed batch is
        queued: the producer thread's copies, overlapped with the
        previous step, are not data wait."""
        it = iter(data)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self._last_data_wait_ms = (time.perf_counter() - t0) * 1e3
            yield batch

    # -- step side ---------------------------------------------------------

    def step(self, batch_size: int = 0,
             auto_commit: bool = True) -> "_StepRecord":
        """`auto_commit=False` defers the registry and journal write to
        an explicit `rec.commit(step=..., metrics=...)` after the
        with-block, so the caller's host reads between the two count in
        step_time_ms and never in dispatch_ms."""
        self._steps_seen += 1
        do_sample = (self._steps_seen % self.sample_every) == 0
        return _StepRecord(self, batch_size, self._last_data_wait_ms,
                           do_sample, auto_commit)

    def _finish(self, rec: "_StepRecord") -> None:
        self._c_steps.inc()
        if rec.batch_size:
            self._c_examples.inc(rec.batch_size)
        self._g_data_wait.set(rec.data_wait_ms)
        self._g_step.set(rec.step_time_ms)
        self._h_step.observe(rec.step_time_ms)
        self._h_wait.observe(rec.data_wait_ms)
        if rec.examples_per_sec is not None:
            self._g_eps.set(rec.examples_per_sec)
        if rec.data_wait_ms > rec.dispatch_ms:
            self._c_starved.inc()
        cs = compile_seconds()
        if cs > self._compile_s_last:
            rec.compile_ms = (cs - self._compile_s_last) * 1e3
            self._compile_s_last = cs
        if rec.sampled:
            self._sync_samples += 1
            n = recompile_count()
            self._g_recompiles.set(n)
            rec.recompiles = n
            hbm, peak = hbm_stats(rec.device)
            if hbm is not None:
                self._g_hbm.set(hbm)
                self._g_hbm_peak.set(peak)
                rec.hbm_bytes, rec.hbm_peak_bytes = hbm, peak
        if self.journal is not None:
            self.journal.step(rec.step if rec.step is not None
                              else self._steps_seen, **rec.fields())

    @property
    def sync_samples(self) -> int:
        return self._sync_samples

    @property
    def steps_seen(self) -> int:
        return self._steps_seen


class _StepRecord:
    """Context manager for one step; collects the timing fields."""

    def __init__(self, clock: StepClock, batch_size: int,
                 data_wait_ms: float, sampled: bool, auto_commit: bool):
        self._clock = clock
        self.batch_size = batch_size
        self.data_wait_ms = data_wait_ms
        self.sampled = sampled
        self.step: Optional[int] = None  # the caller's optimizer step
        self.metrics: dict = {}
        self.extra: dict = {}  # caller-supplied journal fields
        self.device = None  # of the fenced output (_device_of)
        self.dispatch_ms = 0.0
        self.sync_ms: Optional[float] = None
        self.step_time_ms = 0.0
        self.examples_per_sec: Optional[float] = None
        self.recompiles: Optional[int] = None
        self.compile_ms: Optional[float] = None
        self.hbm_bytes: Optional[int] = None
        self.hbm_peak_bytes: Optional[int] = None
        self._t0 = 0.0
        self._fenced = None
        self._auto_commit = auto_commit
        self._committed = False

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def fence_on(self, out) -> None:
        """Hand the step's output here; on sampled steps the stream of
        its first CUDA tensor is synchronized at the with-block's end, so
        sync_ms is the device's queue draining."""
        self._fenced = out
        self.device = _device_of(out)

    def __exit__(self, exc_type, exc, tb):
        self.dispatch_ms = (time.perf_counter() - self._t0) * 1e3
        if self.sampled and self._fenced is not None and exc_type is None:
            t1 = time.perf_counter()
            if self.device is not None and self.device.type == "cuda":
                import torch

                torch.cuda.current_stream(self.device).synchronize()
            self.sync_ms = (time.perf_counter() - t1) * 1e3
        if exc_type is None and self._auto_commit:
            self.commit()
        return False

    def commit(self, step: Optional[int] = None,
               metrics: Optional[dict] = None,
               extra: Optional[dict] = None) -> None:
        """Close the record and write the registry and the journal.
        step_time_ms spans enter -> commit (plus the data wait). `extra`
        fields ride the journal's step row as they are."""
        if self._committed:
            return
        self._committed = True
        if step is not None:
            self.step = step
        if metrics is not None:
            self.metrics = metrics
        if extra:
            self.extra.update(extra)
        self.step_time_ms = self.data_wait_ms + (
            time.perf_counter() - self._t0) * 1e3
        if self.batch_size and self.step_time_ms > 0:
            self.examples_per_sec = self.batch_size / self.step_time_ms * 1e3
        self._clock._finish(self)

    def fields(self) -> dict:
        out = {
            "step_time_ms": round(self.step_time_ms, 3),
            "data_wait_ms": round(self.data_wait_ms, 3),
            "dispatch_ms": round(self.dispatch_ms, 3),
        }
        if self.examples_per_sec is not None:
            out["examples_per_sec"] = round(self.examples_per_sec, 2)
        if self.sync_ms is not None:
            out["sync_ms"] = round(self.sync_ms, 3)
        if self.recompiles is not None:
            out["recompiles"] = self.recompiles
        if self.compile_ms is not None:
            out["compile_ms"] = round(self.compile_ms, 3)
        if self.hbm_bytes is not None:
            out["hbm_bytes"] = self.hbm_bytes
        if self.hbm_peak_bytes is not None:
            out["hbm_peak_bytes"] = self.hbm_peak_bytes
        if self.extra:
            out.update(self.extra)
        if self.metrics:
            out["metrics"] = {k: float(v) for k, v in self.metrics.items()}
        return out
