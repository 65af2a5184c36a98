"""BatchingQueue: coalesce in-flight requests under a max-wait/max-batch
policy (the port of deep_vision_tpu/serve/queue.py).

A request never waits longer than `max_wait_ms` for company, and a batch
never exceeds `max_batch` (the largest warmed bucket). `close()` stops
producers (submit raises `QueueClosed`), and `next_batch` then flushes
what remains in max_batch slices with no lingering, and returns None once
empty. Every queue's condition is the lock role "serve.queue", which
the armed sanitizer (obs/locksmith.py) checks.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional

from deep_vision_tpu_torch.obs import locksmith


class QueueClosed(RuntimeError):
    """submit() after close(): the server is draining or stopped."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before dispatch: it was shed, not
    executed."""


class Request:
    """One in-flight request: payload, promise, clock.

    `accounted` latches once the router has counted the request toward
    completed/errors/cancelled, so it lands in exactly one of them.
    `deadline_ts` (perf_counter seconds, or None) is the client's budget.
    `ctx` carries the request's trace context (obs/propagate.py) from
    the submitting thread to the dispatcher thread, which the
    thread-local slot cannot do.
    """

    __slots__ = ("model", "image", "future", "t_submit", "accounted", "ctx",
                 "deadline_ts")

    def __init__(self, model: str, image):
        self.model = model
        self.image = image
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.accounted = False
        self.ctx = None
        self.deadline_ts: Optional[float] = None


class BatchingQueue:
    """Thread-safe request coalescer for one model: producers `submit`
    from any thread, one dispatcher thread loops on `next_batch`."""

    def __init__(self, max_batch: int, max_wait_ms: float = 5.0,
                 on_depth: Optional[Callable[[int], None]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._on_depth = on_depth
        self._q: deque = deque()
        # one lock role for every model's queue: the sanitizer orders
        # roles, not instances
        self._cond = locksmith.condition("serve.queue")
        self._closed = False

    def submit(self, request: Request) -> None:
        with self._cond:
            if self._closed:
                raise QueueClosed(
                    f"queue for {request.model!r} is draining/closed")
            self._q.append(request)
            depth = len(self._q)
            self._cond.notify_all()
        if self._on_depth is not None:
            self._on_depth(depth)

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def next_batch(self) -> Optional[List[Request]]:
        """Block until a batch is ready; None = closed AND empty (exit).
        Ready means max_batch waiting, the OLDEST request has waited
        max_wait_ms, or the queue is closed."""
        with self._cond:
            while not self._q and not self._closed:
                self._cond.wait()
            if not self._q:
                return None
            if not self._closed:
                # the window is anchored on the oldest request: later
                # arrivals ride it, they do not extend it
                deadline = self._q[0].t_submit + self.max_wait_s
                while len(self._q) < self.max_batch and not self._closed:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            take = min(len(self._q), self.max_batch)
            batch = [self._q.popleft() for _ in range(take)]
            depth = len(self._q)
        if self._on_depth is not None:
            self._on_depth(depth)
        return batch

    def close(self) -> None:
        """Stop accepting; flush what remains. Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
