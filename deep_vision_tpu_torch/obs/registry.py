"""Metrics registry: counters, gauges, log-scale histograms.

A copy of deep_vision_tpu/obs/registry.py's metrics, its Prometheus
text export (which the flight recorder's bundle carries as
metrics.prom) and its per-process file naming: host-side objects, safe
to touch from any thread, with bucket-resolution quantiles. The
reference's JSONL snapshot writer is not ported.

A process's index is its `torch.distributed` rank when a process group
is initialised, else 0; the check reads `sys.modules`, so data workers
that never imported torch never import it here.
"""
from __future__ import annotations

import math
import sys
import threading
from typing import Dict, Iterable, List, Optional, Tuple


def _process_group():
    """torch.distributed when this process has joined a group, else
    None."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() \
                and dist.is_initialized():
            return dist
    except Exception:
        pass
    return None


def process_index() -> int:
    """This process's rank: the group's when one is initialised, else 0."""
    dist = _process_group()
    return int(dist.get_rank()) if dist is not None else 0


def process_count() -> int:
    """The group's world size when one is initialised, else 1."""
    dist = _process_group()
    return int(dist.get_world_size()) if dist is not None else 1


def is_primary_host() -> bool:
    """True when this process should own file writers (rank 0)."""
    return process_index() == 0


def process_suffix() -> str:
    """'.pN' when this process is one of several, else ''.

    The per-process file contract of the journal, the trace and the
    flight bundles: with more than one process every rank writes its own
    file at `<path>.p<rank>`; one process keeps the plain path."""
    if process_count() > 1:
        return f".p{process_index()}"
    return ""


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    # finiteness first: int(NaN) raises, and a NaN gauge must render
    if not math.isfinite(v):
        if v != v:
            return "NaN"
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


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

    def to_prometheus(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self._value)}"]


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

    def to_prometheus(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self._value)}"]


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

    def to_prometheus(self) -> List[str]:
        lines = []
        cumulative = 0
        for bound, c in zip(self.bounds, self._counts):
            cumulative += c
            lb = dict(self.labels, le=_fmt_value(bound))
            lines.append(f"{self.name}_bucket{_fmt_labels(lb)} {cumulative}")
        lb = dict(self.labels, le="+Inf")
        lines.append(f"{self.name}_bucket{_fmt_labels(lb)} {self._count}")
        lines.append(f"{self.name}_sum{_fmt_labels(self.labels)} "
                     f"{_fmt_value(self._sum)}")
        lines.append(f"{self.name}_count{_fmt_labels(self.labels)} "
                     f"{self._count}")
        return lines


class Registry:
    """Named metric store with get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        # the get-or-create lock is locksmith-named; the per-metric leaf
        # locks stay raw: they guard one arithmetic op and never nest
        from deep_vision_tpu_torch.obs import locksmith

        self._lock = locksmith.lock("obs.registry")

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

    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._metrics.values())

    def to_prometheus(self) -> str:
        """Prometheus text exposition: one HELP/TYPE block a metric
        family, with all of the family's label variants under it."""
        families: Dict[str, List[object]] = {}
        for m in self.metrics():
            families.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name, members in families.items():
            head = members[0]
            if head.help:
                lines.append(f"# HELP {name} {head.help}")
            lines.append(f"# TYPE {name} {head.kind}")
            for m in members:
                lines.extend(m.to_prometheus())
        return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT = Registry()


def get_registry() -> Registry:
    """The process-wide default registry."""
    return _DEFAULT
