"""Router/Server: queues in front, the Engine behind (the port of
deep_vision_tpu/serve/router.py).

One `Server` owns one device's serving plane: a `BatchingQueue` and a
dispatcher thread per registered model, all execution funneled through
one device lock. The request path is:

    submit(model, image)                  # any thread; mints the
                                          #   request's trace context
      -> faults.fire("data.read")         # the request-decode boundary:
                                          #   an I/O error, a bad shape or
                                          #   an unknown model fails THIS
                                          #   request's future only
      -> BatchingQueue coalesces (max-wait / max-batch)
      -> deadline shed at dispatch
      -> bucket_for + pad_batch           # round up to a warmed shape
      -> Engine.run, then .cpu()          # the copy to the host is the fence
      -> split rows, resolve futures

Every accepted request ends in exactly one of completed / errors /
cancelled, so a drain can check accepted == completed + errors +
cancelled. With a journal the Server writes typed `serve_request` (with
the request's trace ids), `serve_batch` and `serve_drain` events, plus
`health` on non-finite outputs, each stamped with `tags`; each batch
runs under a `serve/batch` span and the drain under `serve/drain`
(obs/trace.py). Under `health_policy="abort"` a batch with non-finite
outputs fails its requests instead of shipping NaNs. A SIGTERM drain
dumps a `preempt` flight bundle (obs/flight.py); a clean close() leaves
none. The locks are locksmith roles (`serve.device`, `serve.counts`,
`serve.submit`), which the armed sanitizer checks. The JAX server's live
telemetry plane is not ported: `telemetry=` raises.
"""
from __future__ import annotations

import signal
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from deep_vision_tpu_torch.obs import locksmith, propagate
from deep_vision_tpu_torch.obs.trace import span
from deep_vision_tpu_torch.serve.buckets import (
    bucket_for,
    pad_batch,
    split_rows,
)
from deep_vision_tpu_torch.serve.engine import Engine, ServeError
from deep_vision_tpu_torch.serve.queue import (
    BatchingQueue,
    DeadlineExceeded,
    QueueClosed,
    Request,
)
from deep_vision_tpu_torch.serve.slo import SLOTracker

DRAIN_REASONS = ("close", "sigterm")
HEALTH_POLICIES = ("warn", "abort")


class ServerClosed(QueueClosed):
    """submit() on a draining/stopped server."""


class Server:
    """Serving loop over a warmed Engine.

        server = Server(engine, journal=journal, max_wait_ms=5.0).start()
        fut = server.submit("yolo", image)   # -> Future of an output dict
        server.install_sigterm()             # main thread only
        server.wait_for_stop()               # True on SIGTERM
        server.drain("sigterm")              # flush + preempt flight bundle

    `health` (an obs HealthMonitor) gets one beat() a batch; `tags` are
    stamped onto every serve_* and health event this server writes and
    must not shadow the events' own fields.
    """

    def __init__(self, engine: Engine, journal=None, registry=None,
                 max_wait_ms: float = 5.0, drain_timeout_s: float = 30.0,
                 slo_ms: Optional[float] = None,
                 health_policy: str = "warn", health=None,
                 tags: Optional[dict] = None, telemetry=None):
        if health_policy not in HEALTH_POLICIES:
            raise ValueError(
                f"health_policy {health_policy!r} not in {HEALTH_POLICIES}")
        if telemetry is not None:
            raise NotImplementedError(
                "Server(telemetry=): the live telemetry plane is not "
                "ported yet")
        self.engine = engine
        self.journal = journal
        self.tags = dict(tags or {})
        self.slo = SLOTracker(registry=registry, slo_ms=slo_ms)
        self.max_wait_ms = float(max_wait_ms)
        self.drain_timeout_s = float(drain_timeout_s)
        self.health_policy = health_policy
        self.health = health
        self._queues: Dict[str, BatchingQueue] = {}
        self._threads: List[threading.Thread] = []
        # lock roles the armed sanitizer orders: submit -> counts, never
        # the reverse
        self._device_lock = locksmith.lock("serve.device")
        self._count_lock = locksmith.lock("serve.counts")
        # serializes submit's accept-then-enqueue against drain's latch:
        # drain must never see an accepted request that is not yet queued
        self._submit_lock = locksmith.lock("serve.submit")
        self.accepted = 0
        self.completed = 0
        self.errors = 0
        self.cancelled = 0
        self._started = False
        self._drained: Optional[dict] = None
        self._drain_done = threading.Event()
        self._stop = threading.Event()
        self._prev_sigterm = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Server":
        if not self.engine.warmed:
            raise ServeError("start() before engine.warmup(): every batch "
                             "shape must have run before the first request")
        if self._started:
            return self
        for name in self.engine.models:
            q = BatchingQueue(
                max_batch=max(self.engine.entry(name).buckets),
                max_wait_ms=self.max_wait_ms,
                on_depth=lambda d, _m=name: self.slo.queue_depth(_m, d))
            self._queues[name] = q
            t = threading.Thread(target=self._dispatch_loop, args=(name, q),
                                 name=f"serve-{name}", daemon=True)
            self._threads.append(t)
            t.start()
        self._started = True
        return self

    # -- request ingestion ---------------------------------------------------

    def submit(self, model: str, image,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one image for `model`; returns a Future resolving to the
        per-request output dict. A bad shape or unknown model fails this
        request's future, never the server. `deadline_ms` is the client's
        remaining budget from now: a request still queued when it expires
        is shed at dispatch (`DeadlineExceeded`). An I/O error at the
        decode boundary (the `data.read` fault point) fails this request
        only."""
        if not self._started:
            raise ServeError("submit() before start(): no dispatchers are "
                             "running to answer it")
        req = Request(model, image)
        if deadline_ms is not None and deadline_ms > 0:
            req.deadline_ts = req.t_submit + float(deadline_ms) / 1e3
        # ingress mints the trace context: a caller that carries one
        # makes this hop its child, anyone else roots a fresh trace
        parent = propagate.current()
        req.ctx = (parent.child() if parent is not None
                   else propagate.new_trace())
        # decode outside the submit lock: per-request work must not
        # serialize ingestion across client threads
        decode_err: Optional[Exception] = None
        try:
            entry = self.engine.entry(model)
            from deep_vision_tpu_torch.resilience import faults

            faults.fire("data.read")
            arr = np.asarray(req.image, dtype=entry.dtype)
            if tuple(arr.shape) != entry.input_shape:
                raise ServeError(
                    f"request shape {tuple(arr.shape)} != {model!r} input "
                    f"{entry.input_shape} (spatial shapes are static)")
            req.image = arr
        except (ServeError, OSError, ValueError, TypeError) as e:
            decode_err = e
        with self._submit_lock:
            if self._drained is not None or self._stop.is_set():
                raise ServerClosed("server is draining/stopped")
            with self._count_lock:
                self.accepted += 1
            if decode_err is None:
                try:
                    self._queues[model].submit(req)
                except QueueClosed:
                    with self._count_lock:
                        self.accepted -= 1  # never enqueued, nobody owes it
                    raise ServerClosed("server is draining/stopped")
            else:
                self._fail_request(req, decode_err)
        return req.future

    def counts(self) -> dict:
        """One consistent snapshot of the request ledger."""
        with self._count_lock:
            return {"accepted": self.accepted, "completed": self.completed,
                    "errors": self.errors, "cancelled": self.cancelled}

    def _account(self, req: Request, outcome: str, latency_ms: float,
                 error: Optional[str] = None) -> None:
        """Count one request toward exactly one of completed / errors /
        cancelled (latched per request); journal its `serve_request`."""
        if req.accounted:
            return
        req.accounted = True
        with self._count_lock:
            if outcome == "ok":
                self.completed += 1
            elif outcome == "cancelled":
                self.cancelled += 1
            else:
                self.errors += 1
        self.slo.request_done(req.model, latency_ms, outcome)
        if self.journal is not None:
            extra = {"error": error[:200]} if error else {}
            # the request's own context: this may run on the dispatcher
            # thread, whose slot belongs to no request
            if req.ctx is not None:
                extra.update(req.ctx.fields())
            self.journal.write("serve_request", model=req.model,
                               latency_ms=round(latency_ms, 3),
                               outcome=outcome, **self.tags, **extra)

    def _fail_request(self, req: Request, exc: Exception) -> None:
        latency_ms = (time.perf_counter() - req.t_submit) * 1e3
        # a cancelled Future rejects set_exception; the client walked away
        if not req.future.set_running_or_notify_cancel():
            self._account(req, "cancelled", latency_ms)
            return
        req.future.set_exception(exc)
        self._account(req, "error", latency_ms,
                      error=f"{type(exc).__name__}: {exc}")

    # -- dispatch ------------------------------------------------------------

    def _dispatch_loop(self, model: str, q: BatchingQueue) -> None:
        while True:
            batch = q.next_batch()
            if batch is None:
                return
            try:
                self._run_batch(model, batch)
            except Exception as e:  # a poisoned batch fails its requests,
                for req in batch:  # never the dispatcher
                    if req.future.cancelled():
                        self._account(
                            req, "cancelled",
                            (time.perf_counter() - req.t_submit) * 1e3)
                    elif not req.future.done():
                        self._fail_request(req, e)

    def _run_batch(self, model: str, batch: List[Request]) -> None:
        entry = self.engine.entry(model)
        t_pickup = time.perf_counter()
        # a request whose budget ran out in the queue is shed, not run
        expired = [r for r in batch
                   if r.deadline_ts is not None and t_pickup > r.deadline_ts]
        for req in expired:
            late_ms = (t_pickup - req.deadline_ts) * 1e3
            self._fail_request(req, DeadlineExceeded(
                f"deadline passed {late_ms:.1f} ms before dispatch of "
                f"{model!r}"))
        batch = [r for r in batch if r not in expired]
        if not batch:
            return
        bucket = bucket_for(len(batch), entry.buckets)
        t_dispatch = time.perf_counter()
        queue_wait_ms = (t_dispatch - min(r.t_submit for r in batch)) * 1e3
        with span("serve/batch", model=model, bucket=bucket,
                  size=len(batch)):
            images = pad_batch([r.image for r in batch], bucket,
                               dtype=entry.dtype)
            with self._device_lock:
                out = self.engine.run(model, images)
                host = {k: v.cpu().numpy() for k, v in out.items()}
        exec_ms = (time.perf_counter() - t_dispatch) * 1e3
        bad = self._nonfinite_fields(host, len(batch))
        rows = split_rows(host, len(batch))
        t_done = time.perf_counter()
        for req, row in zip(batch, rows):
            latency_ms = (t_done - req.t_submit) * 1e3
            if bad and self.health_policy == "abort":
                # never ship NaNs: the batch's requests fail, the server
                # keeps answering
                self._fail_request(req, ServeError(
                    f"non-finite output fields {bad} (health_policy=abort)"))
                continue
            if not req.future.set_running_or_notify_cancel():
                self._account(req, "cancelled", latency_ms)
                continue
            req.future.set_result(row)
            self._account(req, "ok", latency_ms)
        self.slo.batch_done(model, bucket, len(batch), queue_wait_ms,
                            exec_ms)
        if self.journal is not None:
            self.journal.write(
                "serve_batch", model=model, bucket=int(bucket),
                size=len(batch),
                occupancy_pct=round(100.0 * len(batch) / bucket, 1),
                padding_waste_pct=round(
                    100.0 * (bucket - len(batch)) / bucket, 1),
                queue_wait_ms=round(queue_wait_ms, 3),
                exec_ms=round(exec_ms, 3), **self.tags)
        if bad:
            self._emit_nonfinite(model, bad, len(batch))
        if self.health is not None:
            self.health.beat()  # the serve loop is the watchdog heartbeat

    @staticmethod
    def _nonfinite_fields(host: dict, n: int) -> List[str]:
        """The floating output fields with a non-finite value in the
        batch's real rows."""
        bad = []
        for k, v in host.items():
            a = np.asarray(v)
            if np.issubdtype(a.dtype, np.floating) and \
                    not np.isfinite(a[:n]).all():
                bad.append(str(k))
        return sorted(bad)

    def _emit_nonfinite(self, model: str, fields: List[str],
                        size: int) -> None:
        self.slo.registry.counter(
            "serve_nonfinite_batches_total",
            "batches with non-finite output fields",
            labels={"model": model}).inc()
        if self.journal is not None:
            # the training monitor's typed health event, monitor "serve"
            self.journal.write("health", kind="non_finite",
                               policy=self.health_policy, monitor="serve",
                               fields=fields, action=self.health_policy,
                               model=model, batch_size=size, **self.tags)

    # -- drain / shutdown ----------------------------------------------------

    def drain(self, reason: str = "close") -> dict:
        """Flush every accepted request, then stop. Idempotent (the first
        reason wins). Returns {reason, outcome: flushed|timeout, accepted,
        completed, errors, cancelled, pending}, journaled as
        `serve_drain`; `sigterm` also dumps a `preempt` flight bundle
        (its path under `flight_bundle`, None without a recorder), a
        clean `close` none."""
        if reason not in DRAIN_REASONS:
            raise ValueError(f"drain reason {reason!r} not in {DRAIN_REASONS}")
        with self._submit_lock, self._count_lock:
            already = self._drained is not None
            if not already:
                self._drained = {
                    "reason": reason, "outcome": "timeout",
                    "accepted": self.accepted, "completed": self.completed,
                    "errors": self.errors, "cancelled": self.cancelled,
                    "pending": max(0, self.accepted - self.completed
                                   - self.errors - self.cancelled),
                }
        if already:
            self._drain_done.wait(timeout=self.drain_timeout_s)
            return self._drained
        try:
            deadline = time.perf_counter() + self.drain_timeout_s
            with span("serve/drain", reason=reason):
                for q in self._queues.values():
                    q.close()  # stop accepting; flush-immediately mode
                for t in self._threads:
                    t.join(timeout=max(0.0,
                                       deadline - time.perf_counter()))
                counts = self.counts()
                pending = (counts["accepted"] - counts["completed"]
                           - counts["errors"] - counts["cancelled"])
                outcome = ("flushed" if pending == 0
                           and not any(t.is_alive() for t in self._threads)
                           else "timeout")
                summary = {"reason": reason, "outcome": outcome,
                           **counts, "pending": max(0, pending)}
                if self.journal is not None:
                    self.journal.write("serve_drain", **self.tags, **summary)
                if reason == "sigterm":
                    # the trainer's PreemptionGuard dumps the same reason
                    from deep_vision_tpu_torch.obs import flight

                    summary["flight_bundle"] = \
                        flight.emergency_dump("preempt")
            self._drained = summary
            return summary
        finally:
            self._stop.set()
            self._drain_done.set()

    def close(self) -> dict:
        return self.drain("close")

    # -- SIGTERM wiring ------------------------------------------------------

    def install_sigterm(self) -> None:
        """Arm SIGTERM -> stop flag (main thread only). The handler only
        sets the flag; the owner loop observes it (`wait_for_stop`) and
        runs the drain outside signal context."""
        self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)

    def uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def _on_sigterm(self, signum, frame) -> None:
        self._stop.set()

    def wait_for_stop(self, timeout: Optional[float] = None) -> bool:
        """Block until SIGTERM (or drain/close) flips the stop flag."""
        return self._stop.wait(timeout)
