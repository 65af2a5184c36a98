"""SLO accounting over the obs registry (the port of
deep_vision_tpu/serve/slo.py).

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
  serve_offered_total{model=}        every request the front door saw,
                                     admitted or not (serve/pool.py)
  serve_shed_total{model=,reason=}   requests shed by admission control
                                     (serve/admission.py)
  serve_refused_total{model=}        requests no serving replica took

Fleet gauge (serve/pool.py): `serve_replica_queue_depth{replica=}`, the
in-flight depth of one replica, which least-in-flight routing reads.

A shed request never enters the latency histograms, so `report()` puts
offered, admitted, shed and refused (and offered/admitted RPS) beside
the tail: shedding cannot flatter the p99 unseen.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from deep_vision_tpu_torch.obs.registry import Registry, get_registry

OUTCOMES = ("ok", "error", "rejected", "cancelled")
#: admission-control shed reasons (serve/admission.py); the same enum as
#: the serve_shed reasons that tools/check_journal.py accepts
SHED_REASONS = ("queue_full", "rate_limited", "draining")


class SLOTracker:
    """Per-model serving metrics over one registry."""

    def __init__(self, registry: Optional[Registry] = None,
                 slo_ms: Optional[float] = None):
        self.registry = registry or get_registry()
        self.slo_ms = slo_ms
        self._models: Dict[str, dict] = {}
        self._replica_depth: Dict[str, object] = {}

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
                "offered": r.counter(
                    "serve_offered_total",
                    "requests offered at the front door (incl. shed)",
                    labels=lbl),
                "shed": {reason: r.counter(
                    "serve_shed_total", "requests shed by admission control",
                    labels={"model": model, "reason": reason})
                    for reason in SHED_REASONS},
                "refused": r.counter(
                    "serve_refused_total",
                    "requests refused for want of a serving replica (not "
                    "policy sheds)", labels=lbl),
                # the offer stream's wall-clock window, for the RPS in
                # report(); a racing writer only nudges its edges
                "t_first": None,
                "t_last": None,
            }
            self._models[model] = m
        return m

    def queue_depth(self, model: str, depth: int) -> None:
        self._m(model)["depth"].set(depth)

    def replica_queue_depth(self, replica: str, depth: int) -> None:
        """One replica's in-flight depth (serve/pool.py's routing signal).
        The gauge is cached: this runs per request under the pool's lock,
        where a registry get-or-create would take a second lock."""
        g = self._replica_depth.get(replica)
        if g is None:
            g = self.registry.gauge(
                "serve_replica_queue_depth",
                "requests in flight on one replica",
                labels={"replica": replica})
            self._replica_depth[replica] = g
        g.set(depth)

    def offered(self, model: str) -> None:
        """Count one request at the front door, before admission."""
        m = self._m(model)
        m["offered"].inc()
        now = time.monotonic()
        if m["t_first"] is None:
            m["t_first"] = now
        m["t_last"] = now

    def shed(self, model: str, reason: str) -> None:
        if reason not in SHED_REASONS:
            raise ValueError(f"shed reason {reason!r} not in {SHED_REASONS}")
        self._m(model)["shed"][reason].inc()

    def refused(self, model: str) -> None:
        """An offered request that no serving replica could queue: a fleet
        failure, counted apart from the policy's sheds."""
        self._m(model)["refused"].inc()

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
        slo_violations}, and where requests were offered at a front door
        offered, shed, admitted, refused (when any) and offered_rps /
        admitted_rps; quantiles at histogram-bucket resolution."""
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
            offered = int(m["offered"].value)
            if offered:
                row = out[model]
                shed = sum(int(c.value) for c in m["shed"].values())
                refused = int(m["refused"].value)
                row["offered"] = offered
                row["shed"] = shed
                if refused:
                    row["refused"] = refused
                row["admitted"] = admitted = offered - shed - refused
                window_s = (m["t_last"] or 0.0) - (m["t_first"] or 0.0)
                if window_s > 0:
                    row["offered_rps"] = offered / window_s
                    row["admitted_rps"] = admitted / window_s
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
            + (f"  offered {r['offered']} shed {r['shed']}"
               + (f" ({r['offered_rps']:.1f} -> {r['admitted_rps']:.1f} rps)"
                  if "offered_rps" in r else "")
               if "offered" in r else "")
            for model, r in rep.items())
