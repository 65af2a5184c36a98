"""Run journal: append-only JSONL of typed run events.

The port of deep_vision_tpu/obs/journal.py:55-268. One file per run,
one JSON object per line, with `event`, `ts` and `run_id` on every line,
and the reference's event names and fields, so that
`tools/check_journal.py --strict` accepts the port's journal. The port
writes:

  run_manifest  kind, argv, python, host, pid; torch and CUDA versions,
                the device's name and count (the reference's jax fields)
  step          one per training step, written by the step's StepClock
                (obs/stepclock.py): step_time_ms, data_wait_ms,
                dispatch_ms, examples_per_sec; sync_ms, recompiles,
                compile_ms, hbm_bytes, hbm_peak_bytes where the step
                sampled or compiled; and the caller's fields (the
                Trainer's metrics {loss, lr}, epoch, examples, lr, loss,
                grad_norm, skipped; the GAN loop's epoch, examples, lr)
  epoch, eval   MetricLogger / Trainer.evaluate summaries
  checkpoint    a save started, with save_ms, the time the training
                loop spent in it (the write itself is asynchronous: a
                `note` "checkpoint_written" with write_ms and bytes
                follows when it lands)
  health        obs/health.py findings, and the Server's non-finite
                outputs (monitor "serve")
  serve_request, serve_batch, serve_drain  the Server's (serve/router.py)
  flight_dump   a flight bundle written or failed (obs/flight.py)
  lock_order_violation, lock_contention  the armed lock sanitizer's
                (obs/locksmith.py)
  retry         a RetryPolicy's attempt (resilience/retry.py)
  telemetry_server  the live telemetry server (obs/telemetry.py) bound
                (`started`), closed (`stopped`) or failed to bind
                (`failed`), with host, port, outcome, role and pid
  excache_hit, excache_miss, excache_store, excache_invalid  the
                executable cache's (core/excache.py)
  fault, ckpt_quarantine, preempt_checkpoint, data_resume, note
  crash         atexit marker: the process died without close()
  exit          clean close, with status

A row written while a trace context is installed on the writing thread
(obs/propagate.py `use`) carries its trace_id, span_id and
parent_span_id, unless the caller passed a trace_id itself (the
Server's dispatcher stamps each request's own context).

Events it does not write yet, because their modules are not ported:
`profile` and `profile_capture`, `data_skip`, the goodput and alert
planes' rows, `sharding_resolved`, `backend_*` and `host_*`.

`manifest_row()` hands back the manifest as written, which the
telemetry server's /statusz serves without reading the file again.

The writer flushes every line (a crash loses at most the line in flight)
and registers an atexit hook that stamps `crash` when close() never ran.
Taps (`add_tap`) observe every row after it is written (the flight
recorder rides one); closers (`add_closer`) run on close and on the
crash path. One process writes one file: the reference's per-host `.pN`
journals come with multi-process training.
"""
from __future__ import annotations

import atexit
import json
import os
import platform
import sys
import time
from typing import Callable, List, Optional

from deep_vision_tpu_torch.obs import locksmith, propagate


def _jsonable(v):
    """Best-effort conversion for numpy/torch scalars and containers."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else repr(v)
    try:
        return float(v)  # numpy and torch 0-d arrays and scalars
    except (TypeError, ValueError):
        return repr(v)


class RunJournal:
    """Append-only JSONL journal for one run."""

    def __init__(self, path: str, run_id: Optional[str] = None,
                 kind: str = "train"):
        self.path = path
        self.kind = kind
        self.run_id = run_id or f"{kind}-{os.getpid()}-{int(time.time())}"
        self._closed = False
        self._closers: List[Callable[[], None]] = []
        self._taps: List[Callable[[dict], None]] = []
        # writes come from the train loop and side threads (the health
        # watchdog, the Server's dispatchers): one lock keeps lines whole.
        # The sanitizer checks that nothing holding this lock takes a lock
        # that is held around a write()
        self._lock = locksmith.lock("obs.journal")
        self.dropped_lines = 0  # lines lost to journal I/O errors
        self._manifest_row: Optional[dict] = None  # /statusz identity card
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a")
        atexit.register(self._atexit)  # the crash marker

    # -- lifecycle ---------------------------------------------------------

    def add_tap(self, fn: Callable[[dict], None]) -> None:
        """Register an observer called with every row after it is
        written; a raising tap is swallowed."""
        self._taps.append(fn)

    def add_closer(self, fn: Callable[[], None]) -> None:
        """Register cleanup run by close() and by the atexit crash path
        (Trainer.close, HealthMonitor.stop)."""
        self._closers.append(fn)

    def _run_closers(self) -> None:
        closers, self._closers = self._closers, []
        for fn in closers:
            try:
                fn()
            except Exception as e:  # a failing closer must not mask the rest
                self.write("note", note=f"closer {fn!r} failed: {e!r}")

    def _close_file(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def _atexit(self) -> None:
        if self._closed:
            return
        self._run_closers()
        self.write("crash", reason="process exited without journal.close()")
        self._closed = True
        self._close_file()

    def close(self, status: str = "clean_exit") -> None:
        if self._closed:
            return
        self._run_closers()
        self.write("exit", status=status)
        self._closed = True
        atexit.unregister(self._atexit)
        self._close_file()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close("clean_exit" if exc_type is None
                   else f"exception: {exc_type.__name__}")

    # -- writers -----------------------------------------------------------

    def write(self, event: str, **fields) -> None:
        row = {"event": event, "ts": round(time.time(), 3),
               "run_id": self.run_id}
        # a write under an installed trace context carries its ids; a
        # caller's own trace_id wins
        ctx = propagate.current()
        if ctx is not None and "trace_id" not in fields:
            row.update(ctx.fields())
        row.update({k: _jsonable(v) for k, v in fields.items()})
        # the fault hook sits outside the lock: a fault that journals its
        # own event re-enters write()
        try:
            from deep_vision_tpu_torch.resilience import faults

            faults.fire("journal.flush")
            with self._lock:
                if self._f is not None:
                    self._f.write(json.dumps(row) + "\n")
                    self._f.flush()
        except OSError as e:
            # telemetry degrades, never kills the run it observes
            self.dropped_lines += 1
            if self.dropped_lines == 1:
                print(f"journal: WRITE FAILED ({type(e).__name__}: {e}); "
                      "dropping lines (journal_dropped_lines_total counts "
                      "them)", file=sys.stderr)
            from deep_vision_tpu_torch.obs.registry import get_registry

            get_registry().counter(
                "journal_dropped_lines_total",
                "journal lines lost to I/O errors").inc()
        for tap in self._taps:
            try:
                tap(row)
            except Exception:
                pass

    def manifest(self, config: Optional[dict] = None, **extra) -> None:
        """The run's identity card: what is needed to interpret the
        numbers that follow."""
        info = {
            "kind": self.kind,
            "argv": list(sys.argv),
            "python": platform.python_version(),
            "hostname": platform.node(),
            "pid": os.getpid(),
        }
        try:
            import torch

            info.update(torch_version=torch.__version__,
                        cuda_version=torch.version.cuda,
                        cuda_available=torch.cuda.is_available())
            if torch.cuda.is_available():
                info.update(device_kind=torch.cuda.get_device_name(0),
                            device_count=torch.cuda.device_count())
        except Exception as e:
            info["torch"] = f"unavailable: {e!r}"
        if config is not None:
            info["config"] = config
        info.update(extra)
        self._manifest_row = {k: _jsonable(v) for k, v in info.items()}
        self.write("run_manifest", **info)

    def manifest_row(self) -> Optional[dict]:
        """The manifest as written (None before manifest() runs)."""
        return self._manifest_row

    def step(self, step: int, **fields) -> None:
        self.write("step", step=int(step), **fields)

    def bench(self, name: str, result: dict, **extra) -> None:
        self.write("bench", name=name, result=result, **extra)


def read_journal(path: str) -> List[dict]:
    """Parse a journal JSONL; tolerates a torn final line."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                events.append({"event": "_torn_line", "raw": line[:200]})
    return events
