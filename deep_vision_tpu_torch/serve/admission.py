"""Admission control and load shedding (the port of
deep_vision_tpu/serve/admission.py).

An overloaded server without admission control fails by latency
collapse: every queue grows, every request eventually answers, and the
p99 becomes the timeout. This module decides at the front door whether
a request can be served within its budget and rejects the rest at once
(reject-newest: the queued requests are closest to their deadline, so
the newcomer is the cheapest to turn away).

Two budgets, both per model:

- **bounded queue**: `max_queue_depth` caps the requests in flight
  (accepted, not yet resolved) per model across the pool. Reason:
  `queue_full`.
- **token bucket**: `rate_per_s` + `burst` cap the sustained admission
  rate and allow short bursts. Reason: `rate_limited`.

A draining pool sheds everything with reason `draining`.

Every shed is a typed `serve_shed` journal event and one more on
`serve_shed_total{model,reason}` (serve/slo.py), so offered against
admitted stands in `SLOTracker.report()`. Clients see `ShedError`
synchronously from `ReplicaPool.submit`; no Future is made for a shed
request.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.serve.engine import ServeError
from deep_vision_tpu_torch.serve.slo import SHED_REASONS


class ShedError(ServeError):
    """Request rejected by admission control; carries the shed reason."""

    def __init__(self, model: str, reason: str):
        super().__init__(f"request for {model!r} shed: {reason}")
        self.model = model
        self.reason = reason


class TokenBucket:
    """`burst` tokens of capacity, refilled at `rate_per_s`.

    `take()` spends one token if there is one. The clock is injectable,
    so tests and seeded arrival patterns are exact.
    """

    def __init__(self, rate_per_s: float, burst: int,
                 clock: Callable[[], float] = time.monotonic):
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        if rate_per_s < 0:
            raise ValueError(f"rate_per_s must be >= 0, got {rate_per_s}")
        self.rate_per_s = float(rate_per_s)
        self.burst = int(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def take(self) -> bool:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate_per_s)
        self._t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class AdmissionController:
    """Per-model admission verdicts for a ReplicaPool's front door.

    `admit(model, queue_depth)` returns None (admitted) or a shed reason
    from `slo.SHED_REASONS`. The queue bound is checked before the rate
    budget: a request that a full queue sheds anyway must not spend a
    token that servable traffic needs.

    Thread-safe: one `serve.admission` lock guards the per-model buckets.
    """

    def __init__(self, max_queue_depth: int = 64,
                 rate_per_s: Optional[float] = None,
                 burst: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        self.max_queue_depth = int(max_queue_depth)
        self.rate_per_s = rate_per_s
        self.burst = int(burst if burst is not None
                         else max(1, int(rate_per_s or 1)))
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = locksmith.lock("serve.admission")
        self.draining = False

    def _bucket(self, model: str) -> Optional[TokenBucket]:
        if self.rate_per_s is None:
            return None
        b = self._buckets.get(model)
        if b is None:
            b = TokenBucket(self.rate_per_s, self.burst, clock=self._clock)
            self._buckets[model] = b
        return b

    def admit(self, model: str, queue_depth: int) -> Optional[str]:
        """None = admitted; otherwise the shed reason (SHED_REASONS)."""
        with self._lock:
            if self.draining:
                return "draining"
            if queue_depth >= self.max_queue_depth:
                return "queue_full"
            bucket = self._bucket(model)
            if bucket is not None and not bucket.take():
                return "rate_limited"
            return None

    def start_draining(self) -> None:
        """Every later request sheds with reason `draining`."""
        with self._lock:
            self.draining = True
