"""The live perf status source: the status half of
deep_vision_tpu/obs/perfwatch.py:140-193.

The process-wide "last known perf state" that the telemetry server's
/statusz serves under `perf` (`telemetry_status`): the rolling
step-time p50/p95 of the Trainer's StepClock histogram
(`set_quantile_source`), the process's compiler runs
(obs/stepclock.py `recompile_count`), and the last perf-gate verdict and
trace digest (`note_gate`, `note_digest`). Every read is host state:
the scraper thread never touches the device.

Not ported yet: `profile_compiled` and its `perf_profile` /
`perf_collective` events, which come with the profiler windows
(ROADMAP Queue 1); until then the status has no `last_profile` key.
"""
from __future__ import annotations

from typing import Callable, Optional

from deep_vision_tpu_torch.obs import locksmith

__all__ = [
    "telemetry_status",
    "note_gate",
    "note_digest",
    "set_quantile_source",
]

# one lock, plain dicts only
_state_lock = locksmith.lock("obs.perfwatch")
_LAST = {
    "gate": None,    # {"verdict", "metric", ...}
    "digest": None,  # {"top_op", ...}
}
_QUANTILES: Optional[Callable[[], dict]] = None


def note_gate(verdict: dict) -> None:
    """Record the latest perf-gate verdict for /statusz."""
    with _state_lock:
        _LAST["gate"] = dict(verdict)


def note_digest(summary: dict) -> None:
    """Record the latest trace-digest summary for /statusz."""
    with _state_lock:
        _LAST["digest"] = dict(summary)


def set_quantile_source(fn: Optional[Callable[[], dict]]) -> None:
    """Install the rolling step-time quantile provider (the Trainer wires
    its StepClock histogram here)."""
    global _QUANTILES
    _QUANTILES = fn


def telemetry_status() -> dict:
    """The /statusz "perf" status source: step-time p50/p95, the
    process's compiler runs, the last gate verdict and digest."""
    out: dict = {}
    fn = _QUANTILES
    if fn is not None:
        try:
            out.update(fn())
        except Exception:
            pass
    try:
        from deep_vision_tpu_torch.obs.stepclock import recompile_count

        out["recompiles"] = recompile_count()
    except Exception:
        pass
    with _state_lock:
        if _LAST["gate"] is not None:
            out["gate"] = dict(_LAST["gate"])
        if _LAST["digest"] is not None:
            out["digest"] = dict(_LAST["digest"])
    return out


def _reset_for_tests() -> None:
    with _state_lock:
        _LAST["gate"] = _LAST["digest"] = None
    set_quantile_source(None)
