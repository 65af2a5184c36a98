"""Retry policy: exponential backoff with jitter, a deadline, typed
events.

The port of deep_vision_tpu/resilience/retry.py's `RetryPolicy.call`,
behind which records.py opens a shard (transient I/O on a network
filesystem is retried; corruption inside the file is the bad-record
budget's job) and serve/pool.py respawns a dead replica. Its schedule
and classification are the reference's: the delay before retry k is
base * multiplier**(k-1), capped, then jittered by a policy-owned seeded
RNG; OSError and TimeoutError (or `retry_on`) are retryable, interrupts
never; with `deadline_s`, a call gives up rather than sleep past its
budget. Each retried attempt, give-up and recovery (a success after
failures) is one `note()`: a typed `retry` journal event when a journal
is attached, and one more on `retry_attempts_total{policy=}`,
`retry_giveups_total` or `retry_recoveries_total` in the port's
registry. The reference's predicate, decorator and attempt loop are not
ported.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, Union

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
    deadline_s:    wall budget for one call(); when the NEXT delay would
                   cross it, give up instead of sleeping.
    retry_on:      exception class(es) considered transient.
    journal:       obs RunJournal (or None) for typed `retry` events.
    registry:      obs Registry; defaults to the process-wide one.
    sleep/clock:   injectable for tests.
    """

    def __init__(
        self,
        name: str = "default",
        max_attempts: int = 5,
        base_delay_s: float = 0.5,
        multiplier: float = 2.0,
        max_delay_s: float = 30.0,
        jitter: float = 0.5,
        deadline_s: Optional[float] = None,
        retry_on: _RetryOn = DEFAULT_RETRY_ON,
        journal=None,
        registry=None,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self.retry_on = retry_on
        self.journal = journal
        self._registry = registry
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

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

    def note(self, attempt: int, exc: BaseException, outcome: str,
             delay_s: float = 0.0) -> None:
        """One typed `retry` journal event and its counter. outcome:
        'retrying' (will try again), 'gave_up' (the budget, the deadline
        or the classification stopped it), 'recovered' (a later attempt
        succeeded)."""
        which = {"retrying": "attempts", "gave_up": "giveups",
                 "recovered": "recoveries"}[outcome]
        reg = self._registry if self._registry is not None \
            else get_registry()
        reg.counter(f"retry_{which}_total", f"RetryPolicy {which}",
                    labels={"policy": self.name}).inc()
        if self.journal is not None:
            self.journal.write(
                "retry", name=self.name, attempt=int(attempt),
                error=f"{type(exc).__name__}: {exc}"[:500],
                outcome=outcome, delay_s=round(float(delay_s), 3))

    def call(self, fn: Callable, *args, **kwargs):
        """Run fn(*args, **kwargs) under the policy; the terminal exception
        (non-retryable, or the budget or deadline spent) re-raises
        unchanged."""
        start = self._clock()
        attempt = 0
        while True:
            try:
                result = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - classified below
                attempt += 1
                if not self.should_retry(attempt, e):
                    self.note(attempt, e, "gave_up")
                    raise
                d = self.delay(attempt)
                if (self.deadline_s is not None
                        and self._clock() - start + d > self.deadline_s):
                    self.note(attempt, e, "gave_up")
                    raise
                self.note(attempt, e, "retrying", delay_s=d)
                if d > 0:
                    self._sleep(d)
                continue
            if attempt:
                self.note(attempt, _Recovered(), "recovered")
            return result


class _Recovered(Exception):
    """The placeholder error of a `recovered` event (no live error)."""

    def __str__(self):
        return "recovered"
