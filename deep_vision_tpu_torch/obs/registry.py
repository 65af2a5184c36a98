"""Metrics registry: counters, gauges, log-scale histograms.

A copy of the part of deep_vision_tpu/obs/registry.py that serving reads
(serve/slo.py, inference.py): host-side objects, safe to touch from any
thread, with bucket-resolution quantiles. The Prometheus/JSONL exporters
and the multi-host file suffixes come with the observability slice.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple


def default_log_buckets(lo: float = 1e-3, hi: float = 1e5,
                        per_decade: int = 3) -> List[float]:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (i / per_decade) for i in range(n + 1)]


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram, 3 log buckets per decade by default
    (1e-3 .. 1e5, ms scale)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None,
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds: List[float] = sorted(buckets) if buckets \
            else default_log_buckets()
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-th observation."""
        if not self._count:
            return 0.0
        target = q * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else math.inf
        return math.inf


class Registry:
    """Named metric store with get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[dict], **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)


_DEFAULT = Registry()


def get_registry() -> Registry:
    """The process-wide default registry."""
    return _DEFAULT
