"""Router/Server: queues in front, the Engine behind (the port of
deep_vision_tpu/serve/router.py).

One `Server` owns one device's serving plane: a `BatchingQueue` and a
dispatcher thread per registered model, all execution funneled through
one device lock. The request path is:

    submit(model, image)                  # any thread; bad shape or
                                          #   unknown model fails THIS
                                          #   request's future only
      -> BatchingQueue coalesces (max-wait / max-batch)
      -> deadline shed at dispatch
      -> bucket_for + pad_batch           # round up to a warmed shape
      -> Engine.run, then .cpu()          # the copy to the host is the fence
      -> split rows, resolve futures

Every accepted request ends in exactly one of completed / errors /
cancelled, so a drain can check accepted == completed + errors +
cancelled. The journal events, trace spans, telemetry, health policy,
flight bundles and the `data.read` fault boundary of the JAX server come
with the observability slice.
"""
from __future__ import annotations

import signal
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

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


class ServerClosed(QueueClosed):
    """submit() on a draining/stopped server."""


class Server:
    """Serving loop over a warmed Engine.

        server = Server(engine, max_wait_ms=5.0).start()
        fut = server.submit("yolo", image)   # -> Future of an output dict
        server.install_sigterm()             # main thread only
        server.wait_for_stop()               # True on SIGTERM
        server.drain("sigterm")              # flush every accepted request
    """

    def __init__(self, engine: Engine, registry=None,
                 max_wait_ms: float = 5.0, drain_timeout_s: float = 30.0,
                 slo_ms: Optional[float] = None):
        self.engine = engine
        self.slo = SLOTracker(registry=registry, slo_ms=slo_ms)
        self.max_wait_ms = float(max_wait_ms)
        self.drain_timeout_s = float(drain_timeout_s)
        self._queues: Dict[str, BatchingQueue] = {}
        self._threads: List[threading.Thread] = []
        self._device_lock = threading.Lock()
        self._count_lock = threading.Lock()
        # serializes submit's accept-then-enqueue against drain's latch:
        # drain must never see an accepted request that is not yet queued
        self._submit_lock = threading.Lock()
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
        is shed at dispatch (`DeadlineExceeded`)."""
        if not self._started:
            raise ServeError("submit() before start(): no dispatchers are "
                             "running to answer it")
        req = Request(model, image)
        if deadline_ms is not None and deadline_ms > 0:
            req.deadline_ts = req.t_submit + float(deadline_ms) / 1e3
        decode_err: Optional[Exception] = None
        try:
            entry = self.engine.entry(model)
            arr = np.asarray(req.image, dtype=entry.dtype)
            if tuple(arr.shape) != entry.input_shape:
                raise ServeError(
                    f"request shape {tuple(arr.shape)} != {model!r} input "
                    f"{entry.input_shape} (spatial shapes are static)")
            req.image = arr
        except (ServeError, ValueError, TypeError) as e:
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

    def _account(self, req: Request, outcome: str, latency_ms: float) -> None:
        """Count one request toward exactly one of completed / errors /
        cancelled (latched per request)."""
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

    def _fail_request(self, req: Request, exc: Exception) -> None:
        latency_ms = (time.perf_counter() - req.t_submit) * 1e3
        # a cancelled Future rejects set_exception; the client walked away
        if not req.future.set_running_or_notify_cancel():
            self._account(req, "cancelled", latency_ms)
            return
        req.future.set_exception(exc)
        self._account(req, "error", latency_ms)

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
        images = pad_batch([r.image for r in batch], bucket,
                           dtype=entry.dtype)
        with self._device_lock:
            out = self.engine.run(model, images)
            host = {k: v.cpu().numpy() for k, v in out.items()}
        exec_ms = (time.perf_counter() - t_dispatch) * 1e3
        rows = split_rows(host, len(batch))
        t_done = time.perf_counter()
        for req, row in zip(batch, rows):
            latency_ms = (t_done - req.t_submit) * 1e3
            if not req.future.set_running_or_notify_cancel():
                self._account(req, "cancelled", latency_ms)
                continue
            req.future.set_result(row)
            self._account(req, "ok", latency_ms)
        self.slo.batch_done(model, bucket, len(batch), queue_wait_ms,
                            exec_ms)

    # -- drain / shutdown ----------------------------------------------------

    def drain(self, reason: str = "close") -> dict:
        """Flush every accepted request, then stop. Idempotent (the first
        reason wins). Returns {reason, outcome: flushed|timeout, accepted,
        completed, errors, cancelled, pending}."""
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
            for q in self._queues.values():
                q.close()  # stop accepting; flush-immediately mode
            for t in self._threads:
                t.join(timeout=max(0.0, deadline - time.perf_counter()))
            counts = self.counts()
            pending = (counts["accepted"] - counts["completed"]
                       - counts["errors"] - counts["cancelled"])
            outcome = ("flushed" if pending == 0
                       and not any(t.is_alive() for t in self._threads)
                       else "timeout")
            self._drained = {"reason": reason, "outcome": outcome,
                             **counts, "pending": max(0, pending)}
            return self._drained
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
