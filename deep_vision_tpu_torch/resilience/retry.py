"""Retry policy: exponential backoff with jitter, and counters.

The part of deep_vision_tpu/resilience/retry.py that the data feed uses:
`RetryPolicy.call`, behind which records.py opens a shard (transient I/O
on a network filesystem is retried; corruption inside the file is the
bad-record budget's job). Its schedule and classification are the
reference's: the delay before retry k is base * multiplier**(k-1),
capped, then jittered by a policy-owned seeded RNG; OSError and
TimeoutError (or `retry_on`) are retryable, interrupts never. Each
retried attempt adds one to `retry_attempts_total{policy=}` in the
port's registry, a give-up to `retry_giveups_total`, and a success after
failures to `retry_recoveries_total`. The reference's journal events, deadline,
predicate, decorator and attempt loop come with the resilience slice.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Tuple, Type, Union

from deep_vision_tpu_torch.obs.registry import get_registry

_RetryOn = Union[Type[BaseException], Tuple[Type[BaseException], ...]]

#: the default classification: transient-looking I/O and transport errors
DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)


class RetryPolicy:
    """Backoff schedule + retryable-exception classification + budget.

    name:          labels the counters.
    max_attempts:  total tries including the first (<=0 means "no retries").
    base_delay_s / multiplier / max_delay_s: exponential backoff envelope.
    jitter:        +-fraction applied to each delay (0.5 -> 50%-150%).
    retry_on:      exception class(es) considered transient.
    registry:      obs Registry; defaults to the process-wide one.
    sleep:         injectable for tests.
    """

    def __init__(
        self,
        name: str = "default",
        max_attempts: int = 5,
        base_delay_s: float = 0.5,
        multiplier: float = 2.0,
        max_delay_s: float = 30.0,
        jitter: float = 0.5,
        retry_on: _RetryOn = DEFAULT_RETRY_ON,
        registry=None,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.name = name
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.retry_on = retry_on
        self._registry = registry
        self._rng = random.Random(seed)
        self._sleep = sleep

    def classify(self, exc: BaseException) -> bool:
        """Is this exception retryable under the policy?"""
        if isinstance(exc, (KeyboardInterrupt, SystemExit)):
            return False  # never eat an operator interrupt or a crash fault
        return isinstance(exc, self.retry_on)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based), jittered."""
        d = self.base_delay_s * self.multiplier ** max(0, attempt - 1)
        d = min(d, self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def should_retry(self, attempt: int, exc: BaseException) -> bool:
        """Budget + classification in one check: `attempt` failures so far."""
        return attempt < self.max_attempts and self.classify(exc)

    def _count(self, which: str) -> None:
        reg = self._registry if self._registry is not None \
            else get_registry()
        reg.counter(f"retry_{which}_total", f"RetryPolicy {which}",
                    labels={"policy": self.name}).inc()

    def call(self, fn: Callable, *args, **kwargs):
        """Run fn(*args, **kwargs) under the policy; the terminal exception
        (non-retryable, or the budget spent) re-raises unchanged."""
        attempt = 0
        while True:
            try:
                result = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - classified below
                attempt += 1
                if not self.should_retry(attempt, e):
                    self._count("giveups")
                    raise
                d = self.delay(attempt)
                self._count("attempts")
                if d > 0:
                    self._sleep(d)
                continue
            if attempt:
                self._count("recoveries")
            return result
