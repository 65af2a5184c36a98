"""SLO accounting over the obs registry (the port of
deep_vision_tpu/serve/slo.py, without the admission-control counters,
which come with the admission layer).

Tracked per model:

  serve_request_latency_ms{model=}   submit -> result, histogram
  serve_queue_wait_ms{model=}        oldest-request coalescing wait
  serve_exec_ms{model=}              device execute + host fetch
  serve_requests_total{model=,outcome=}  ok / error / rejected / cancelled
  serve_queue_depth{model=}          gauge
  serve_batch_occupancy_pct{model=}  last batch: real rows / bucket rows
  serve_padding_waste_pct{model=}    last batch: padded rows / bucket rows
  serve_batches_total{model=}
  serve_batch_slots_total{model=} / serve_padded_slots_total{model=}
  serve_slo_violations_total{model=} requests over slo_ms, when set
"""
from __future__ import annotations

from typing import Dict, Optional

from deep_vision_tpu_torch.obs.registry import Registry, get_registry

OUTCOMES = ("ok", "error", "rejected", "cancelled")


class SLOTracker:
    """Per-model serving metrics over one registry."""

    def __init__(self, registry: Optional[Registry] = None,
                 slo_ms: Optional[float] = None):
        self.registry = registry or get_registry()
        self.slo_ms = slo_ms
        self._models: Dict[str, dict] = {}

    def _m(self, model: str) -> dict:
        m = self._models.get(model)
        if m is None:
            r, lbl = self.registry, {"model": model}
            m = {
                "latency": r.histogram(
                    "serve_request_latency_ms",
                    "request latency, submit -> result", labels=lbl),
                "queue_wait": r.histogram(
                    "serve_queue_wait_ms",
                    "oldest-request wait before dispatch", labels=lbl),
                "exec": r.histogram(
                    "serve_exec_ms", "batch execute + host fetch",
                    labels=lbl),
                "requests": {o: r.counter(
                    "serve_requests_total", "requests by outcome",
                    labels={"model": model, "outcome": o})
                    for o in OUTCOMES},
                "depth": r.gauge(
                    "serve_queue_depth", "requests waiting to batch",
                    labels=lbl),
                "occupancy": r.gauge(
                    "serve_batch_occupancy_pct",
                    "last batch: real rows / bucket rows", labels=lbl),
                "waste": r.gauge(
                    "serve_padding_waste_pct",
                    "last batch: padded rows / bucket rows", labels=lbl),
                "batches": r.counter(
                    "serve_batches_total", "batches dispatched", labels=lbl),
                "slots": r.counter(
                    "serve_batch_slots_total", "bucket rows dispatched",
                    labels=lbl),
                "padded": r.counter(
                    "serve_padded_slots_total", "bucket rows that were pad",
                    labels=lbl),
                "violations": r.counter(
                    "serve_slo_violations_total",
                    "requests over the slo_ms target", labels=lbl),
            }
            self._models[model] = m
        return m

    def queue_depth(self, model: str, depth: int) -> None:
        self._m(model)["depth"].set(depth)

    def request_done(self, model: str, latency_ms: float,
                     outcome: str = "ok") -> None:
        m = self._m(model)
        m["requests"][outcome if outcome in OUTCOMES else "error"].inc()
        if outcome == "ok":
            m["latency"].observe(latency_ms)
            if self.slo_ms is not None and latency_ms > self.slo_ms:
                m["violations"].inc()

    def batch_done(self, model: str, bucket: int, size: int,
                   queue_wait_ms: float, exec_ms: float) -> None:
        m = self._m(model)
        m["batches"].inc()
        m["slots"].inc(bucket)
        m["padded"].inc(bucket - size)
        m["occupancy"].set(100.0 * size / bucket)
        m["waste"].set(100.0 * (bucket - size) / bucket)
        m["queue_wait"].observe(queue_wait_ms)
        m["exec"].observe(exec_ms)

    def report(self) -> Dict[str, dict]:
        """model -> {requests, errors, rejected, cancelled, p50/p95/p99_ms,
        mean_ms, batches, occupancy_pct, padding_waste_pct,
        slo_violations}; quantiles at histogram-bucket resolution."""
        out: Dict[str, dict] = {}
        for model, m in sorted(self._models.items()):
            slots = m["slots"].value
            out[model] = {
                "requests": int(m["requests"]["ok"].value),
                "errors": int(m["requests"]["error"].value),
                "rejected": int(m["requests"]["rejected"].value),
                "cancelled": int(m["requests"]["cancelled"].value),
                "p50_ms": m["latency"].quantile(0.5),
                "p95_ms": m["latency"].quantile(0.95),
                "p99_ms": m["latency"].quantile(0.99),
                "mean_ms": m["latency"].mean,
                "batches": int(m["batches"].value),
                "occupancy_pct": (100.0 * (slots - m["padded"].value) / slots
                                  if slots else 0.0),
                "padding_waste_pct": (100.0 * m["padded"].value / slots
                                      if slots else 0.0),
                "slo_violations": int(m["violations"].value),
            }
        return out

    def render(self) -> str:
        """One text line per model."""
        rep = self.report()
        if not rep:
            return "slo: no serving traffic recorded"
        return "\n".join(
            f"{model}: {r['requests']} ok, {r['errors']} err  "
            f"latency mean {r['mean_ms']:.2f}ms p50 {r['p50_ms']:.2f} "
            f"p95 {r['p95_ms']:.2f} p99 {r['p99_ms']:.2f}  "
            f"batches {r['batches']} occupancy {r['occupancy_pct']:.1f}% "
            f"waste {r['padding_waste_pct']:.1f}%"
            + (f"  slo>{self.slo_ms:g}ms: {r['slo_violations']}"
               if self.slo_ms is not None else "")
            for model, r in rep.items())
