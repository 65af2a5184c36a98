"""Span tracer: Chrome trace-event JSON that says where the time went
(the port of deep_vision_tpu/obs/trace.py).

The journal says what happened each step; spans say where inside the
step the host's time went: data fetch against augment against the step
against eval against checkpoint I/O. The output is the Trace Event
Format's complete events ("ph": "X"), so one file loads in Perfetto or
chrome://tracing.

- **No cost when off.** Every instrumentation site calls the
  module-level `span(...)`; with no tracer installed it returns one
  shared no-op context manager. Data workers import this module, so it
  imports no torch.
- **Valid JSON on disk at all times.** flush() rewrites the whole file
  atomically (tmp + os.replace); spans buffer in memory and flush every
  `flush_every` completions (a cadence that grows with the buffer), at
  close() and from an atexit hook.
- **Thread-safe.** Producer threads (the loader's prefetch, the
  watchdog, the Server's dispatchers) record spans beside the train
  loop; each event carries its thread id, with one thread-name metadata
  event a thread. With several processes each rank writes its own file
  (`<path>.pN`, obs/registry.process_suffix).
- **Host time only.** A span brackets host code: on the card, a step's
  span is the time the host took to issue it, and no span synchronises
  the device.

The tracer carries the journal's `run_id` in its metadata, and spans
carry a `step` arg where the caller knows it, so a timeline and a
journal describe the same run. A ring buffer (`max_events`) keeps the
newest events and counts the dropped ones.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from deep_vision_tpu_torch.obs import locksmith, propagate
from deep_vision_tpu_torch.obs.registry import is_primary_host, process_suffix

# Trace-event timestamps are microseconds. Use an epoch-anchored clock so
# trace ts and journal ts (unix seconds) cross-reference directly:
# perf_counter offsets from a wall-clock anchor keep monotonicity within
# the run while staying on the journal's time axis.
_ANCHOR_WALL = time.time()
_ANCHOR_PERF = time.perf_counter()


def _now_us() -> float:
    return (_ANCHOR_WALL + (time.perf_counter() - _ANCHOR_PERF)) * 1e6


class _NullSpan:
    """Shared do-nothing span: the off-switch for every call site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One in-flight span; records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **args) -> None:
        """Attach args discovered mid-span (e.g. the optimizer step, which
        is only known after the state fetch)."""
        self.args.update(args)

    def __enter__(self):
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._record(self.name, self._t0, _now_us(), self.args)
        return False


class Tracer:
    """Buffered Chrome trace-event writer for one run.

    Usage:

        tracer = Tracer("runs/train.trace.json", run_id=journal.run_id)
        with tracer.span("train/step", step=12):
            ...
        tracer.close()

    or install it process-wide (`set_tracer`) and use the module-level
    `span(...)` from any layer.
    """

    def __init__(self, path: str, run_id: Optional[str] = None,
                 flush_every: int = 256, max_events: int = 200_000):
        # multi-process runs: one trace file per process at `<path>.pN`;
        # followers write their own file instead of collecting silently
        sfx = process_suffix()
        self.path = path + sfx
        self.run_id = run_id
        self.flush_every = max(1, int(flush_every))
        # ring-buffer cap: a post-mortem wants the most RECENT window, and
        # an uncapped buffer on a week-long run is an OOM of its own
        self.max_events = max(1000, int(max_events))
        self._events: List[dict] = []
        self._dropped = 0
        self._lock = locksmith.lock("obs.trace.buffer")
        # flush serialization is separate from the buffer lock: the file
        # write must not block recorders, but two concurrent flushes with
        # one tmp name would publish a torn file
        self._flush_lock = locksmith.lock("obs.trace.flush")
        self._closed = False
        self._primary = is_primary_host() or bool(sfx)
        self._pid = os.getpid()
        self._thread_named: Dict[int, str] = {}  # ident -> last-seen name
        self._unflushed = 0
        if self._primary:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        atexit.register(self._atexit)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        # cross-process causality: a span opened while a trace context is
        # installed (obs/propagate.py) carries the request's ids, so the
        # Perfetto view and the journal agree on which request this was
        ctx = propagate.current()
        if ctx is not None and "trace_id" not in args:
            args = dict(args, **ctx.fields())
        return _Span(self, name, args)

    def event(self, name: str, t0_us: float, t1_us: Optional[float] = None,
              **args) -> None:
        """Explicit complete event for callers that time a region that
        doesn't nest as a with-block (e.g. the data pipeline's per-batch
        assembly, which spans loop iterations)."""
        self._record(name, t0_us, t1_us if t1_us is not None else _now_us(),
                     args)

    def _record(self, name: str, t0_us: float, t1_us: float,
                args: dict) -> None:
        if self._closed or not self._primary:
            # followers never write a file, so buffering their events
            # would be a leak with no consumer
            return
        t = threading.current_thread()
        tid = t.ident or 0
        ev = {
            "name": name,
            "ph": "X",
            "ts": round(t0_us, 1),
            "dur": round(max(t1_us - t0_us, 0.0), 1),
            "pid": self._pid,
            "tid": tid,
        }
        if args:
            ev["args"] = {k: _arg(v) for k, v in args.items()}
        with self._lock:
            # keyed on ident AND name: the OS reuses thread ids, so a
            # short-lived worker's successor with the same ident still
            # gets its own metadata event (last-writer-wins in viewers)
            if self._thread_named.get(tid) != t.name:
                self._thread_named[tid] = t.name
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid, "args": {"name": t.name},
                })
            self._events.append(ev)
            if len(self._events) > self.max_events:
                # drop the oldest quarter in one slice (per-event pops
                # would be O(n) each); metadata reports the loss
                cut = len(self._events) // 4
                del self._events[:cut]
                self._dropped += cut
            self._unflushed += 1
            # adaptive cadence: every flush rewrites the whole file (the
            # price of always-valid JSON), so the interval grows with the
            # buffer — total I/O stays ~4x the final file size instead of
            # O(n^2/flush_every)
            do_flush = self._unflushed >= max(self.flush_every,
                                              len(self._events) // 4)
        if do_flush:
            self.flush()

    # -- persistence -------------------------------------------------------

    def flush(self) -> None:
        """Atomically rewrite the trace file with everything recorded so
        far; the on-disk file is valid Chrome trace JSON at all times."""
        if not self._primary:
            return
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
            self._unflushed = 0
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"run_id": self.run_id, "pid": self._pid,
                         "dropped_events": dropped},
        }
        # serialized: concurrent flushes sharing one tmp name would
        # truncate each other mid-dump and publish a torn file
        with self._flush_lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)

    def _atexit(self) -> None:
        if not self._closed:
            self.close()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._closed = True
        atexit.unregister(self._atexit)

    @property
    def num_events(self) -> int:
        with self._lock:
            return len(self._events)

    def tail(self, n: int = 256) -> List[dict]:
        """The most recent `n` buffered events (complete + metadata) — the
        span tail a flight-recorder bundle snapshots at dump time."""
        with self._lock:
            return [dict(e) for e in self._events[-max(0, int(n)):]]


def _arg(v):
    """Span args must never poison the JSON dump (same contract as
    journal._jsonable, minus containers — span args are flat)."""
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else repr(v)
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


# -- process-wide active tracer ----------------------------------------------

_active: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install (or clear, with None) the process-wide tracer that the
    module-level `span`/`trace_event` report to."""
    global _active
    _active = tracer


def get_tracer() -> Optional[Tracer]:
    return _active


def span(name: str, **args):
    """A span on the active tracer, or a shared no-op when tracing is off.

    The instrumentation idiom used by every layer:

        with span("data/fetch", loader=self.name):
            batch = q.get()
    """
    t = _active
    if t is None:
        return _NULL_SPAN
    return t.span(name, **args)


def trace_event(name: str, t0_us: float, t1_us: Optional[float] = None,
                **args) -> None:
    """Explicit complete event on the active tracer (no-op when off)."""
    t = _active
    if t is not None:
        t.event(name, t0_us, t1_us, **args)


def now_us() -> float:
    """The tracer's clock, for callers building explicit trace_event()s."""
    return _now_us()


def traced(name: Optional[str] = None, **static_args) -> Callable:
    """Decorator: wrap a function in a span named after it.

        @traced("checkpoint/save")
        def save(...): ...
    """
    def deco(fn: Callable) -> Callable:
        span_name = name or fn.__qualname__

        def wrapper(*a, **kw):
            with span(span_name, **static_args):
                return fn(*a, **kw)

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper

    return deco
