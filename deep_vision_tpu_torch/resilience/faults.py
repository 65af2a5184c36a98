"""Deterministic, seeded fault injection at the port's I/O boundaries.

The port of deep_vision_tpu/resilience/faults.py:86-320, pure host code.
Named injection points compile to one module-global None-check when no
spec is installed. The port fires `ckpt.save`, `ckpt.restore` and
`ckpt.sidecar` (with its `after_write` stage, the torn-write window
between the sidecar's tmp write and its rename) in core/checkpoint.py,
`journal.flush` in obs/journal.py, and `data.read` at the Server's
request-decode boundary (serve/router.py submit); the data feed's
`data.read` and `data.decode` hooks are not fired yet, and the
replica, transport and data-service points wait for their modules.

Spec grammar (the `--fault-spec` string of the reference's CLI)::

    point:kind[@when][;point:kind[@when]...]

`when` is a probability when it parses as a float < 1, and "fire exactly
on the Nth hit of this point, once" when it is an integer >= 1; omitted,
it means 1. Kinds: `io_error` raises FaultInjected (an IOError),
`crash` SIGKILLs the process at the point, `crash_after_write` SIGKILLs
it at the point's after-write stage, `corrupt` flips bytes in data
passed through `transform()`.

Rate faults draw from a per-rule `random.Random` seeded from
(seed, point, kind). Installation exports DVT_FAULT_SPEC / DVT_FAULT_SEED
so spawned data workers inherit the spec (this module installs from them
at import). A fired fault writes a typed `fault` journal event when a
journal is attached and adds one to `fault_injected_total{point=,kind=}`.
An injected crash first dumps the flight recorder's
`injected_<kind>` bundle (obs/flight.py), fsynced and renamed before the
SIGKILL; a failed dump is swallowed and the kill goes ahead.
"""
from __future__ import annotations

import os
import random
import signal
import sys
import threading
from typing import List, Optional

from deep_vision_tpu_torch.core import knobs

ENV_SPEC = "DVT_FAULT_SPEC"
ENV_SEED = "DVT_FAULT_SEED"

#: the reference's injection points; parse() rejects unknown ones so a
#: typo'd spec fails loudly instead of silently injecting nothing
POINTS = ("data.read", "data.decode", "ckpt.save", "ckpt.restore",
          "ckpt.sidecar", "journal.flush", "serve.replica", "data.service",
          "serve.transport")
KINDS = ("io_error", "crash", "crash_after_write", "corrupt")


class FaultInjected(IOError):
    """The injected transient I/O error; an IOError so every real handler
    (retry policies, bad-record budgets) treats it as the real thing."""


class FaultSpecError(ValueError):
    """Unparseable fault spec string."""


class _Rule:
    def __init__(self, point: str, kind: str, when: float, seed: int):
        self.point = point
        self.kind = kind
        # float in (0, 1): per-hit probability; int >= 1: the Nth hit, once
        self.probability = when if when < 1.0 else None
        self.nth = int(when) if when >= 1.0 else None
        self.hits = 0
        self.fired = 0
        self._rng = random.Random(f"{seed}:{point}:{kind}")
        # a point can be hit from several threads: the count stays exact
        self._tlock = threading.Lock()

    def triggers(self) -> bool:
        with self._tlock:
            self.hits += 1
            if self.nth is not None:
                if self.hits == self.nth:
                    self.fired += 1
                    return True
                return False
            if self._rng.random() < self.probability:
                self.fired += 1
                return True
            return False

    def __repr__(self):
        when = self.nth if self.nth is not None else f"@{self.probability}"
        return f"_Rule({self.point}:{self.kind}@{when}, fired={self.fired})"


class FaultInjector:
    """Holds the parsed rules; `fire`/`transform` are its two hooks."""

    def __init__(self, rules: List[_Rule], seed: int = 0, journal=None):
        self.rules = rules
        self.seed = seed
        self.journal = journal
        self.spec = ";".join(
            f"{r.point}:{r.kind}@{r.nth if r.nth is not None else r.probability}"
            for r in rules)

    @classmethod
    def parse(cls, spec: str, seed: int = 0,
              journal=None) -> "FaultInjector":
        rules: List[_Rule] = []
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                point, rest = part.split(":", 1)
            except ValueError:
                raise FaultSpecError(
                    f"fault spec entry {part!r} is not 'point:kind[@when]'")
            if "@" in rest:
                kind, when_s = rest.split("@", 1)
                try:
                    when = float(when_s)
                except ValueError:
                    raise FaultSpecError(
                        f"fault spec {part!r}: '@{when_s}' is neither a "
                        "probability (<1) nor an Nth-hit integer (>=1)")
                if when <= 0:
                    raise FaultSpecError(
                        f"fault spec {part!r}: '@{when_s}' must be positive")
            else:
                kind, when = rest, 1.0
            point, kind = point.strip(), kind.strip()
            if point not in POINTS:
                raise FaultSpecError(
                    f"unknown injection point {point!r}; have {POINTS}")
            if kind not in KINDS:
                raise FaultSpecError(
                    f"unknown fault kind {kind!r}; have {KINDS}")
            rules.append(_Rule(point, kind, when, seed))
        return cls(rules, seed=seed, journal=journal)

    def set_journal(self, journal) -> None:
        """Attach the run journal after install."""
        self.journal = journal

    def _note(self, point: str, kind: str, stage: Optional[str]) -> None:
        from deep_vision_tpu_torch.obs.registry import get_registry

        get_registry().counter("fault_injected_total", "injected faults fired",
                               labels={"point": point, "kind": kind}).inc()
        # a journal.flush fault must not journal itself: RunJournal.write
        # is the caller one frame up
        if self.journal is not None and point != "journal.flush":
            self.journal.write("fault", point=point, kind=kind,
                               **({"stage": stage} if stage else {}))

    def fire(self, point: str, stage: Optional[str] = None) -> None:
        """Raise or crash if a rule for `point` (at `stage`) triggers.
        stage=None is a point's primary position (io_error/crash rules);
        stage="after_write" is the post-tmp-write position that only
        crash_after_write rules match."""
        for r in self.rules:
            if r.point != point:
                continue
            if (r.kind == "crash_after_write") != (stage == "after_write"):
                continue
            if r.kind == "corrupt":
                continue  # corrupt rules act in transform()
            if not r.triggers():
                continue
            self._note(point, r.kind, stage)
            if r.kind == "io_error":
                raise FaultInjected(
                    f"injected io_error at {point}"
                    + (f" (stage={stage})" if stage else ""))
            # crash / crash_after_write: die as a real preemption does,
            # with no handlers, no atexit and no flushed buffers; the
            # flight bundle is the one artefact written first
            try:
                from deep_vision_tpu_torch.obs import flight

                flight.emergency_dump(f"injected_{r.kind}")
            except Exception:
                pass
            sys.stderr.write(
                f"faults: injected {r.kind} at {point} — SIGKILL\n")
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    def transform(self, point: str, data: bytes) -> bytes:
        """Pass `data` through any triggered corrupt rules for `point`:
        flip a byte in the middle and truncate the tail."""
        for r in self.rules:
            if r.point != point or r.kind != "corrupt":
                continue
            if not r.triggers():
                continue
            self._note(point, "corrupt", None)
            if not data:
                return b"\xff"
            mid = len(data) // 2
            data = (data[:mid]
                    + bytes([data[mid] ^ 0xFF])
                    + data[mid + 1:max(mid + 1, len(data) - 3)])
        return data


_INSTALLED: Optional[FaultInjector] = None


def installed() -> Optional[FaultInjector]:
    return _INSTALLED


def install(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install (or, with None, clear) the process-wide injector."""
    global _INSTALLED
    _INSTALLED = inj
    return inj


def install_spec(spec: Optional[str], seed: int = 0, journal=None,
                 export_env: bool = True) -> Optional[FaultInjector]:
    """Parse and install a spec string; with export_env, also export it
    so spawned data workers inherit it. An empty spec clears both."""
    if not spec:
        if export_env:
            os.environ.pop(ENV_SPEC, None)
            os.environ.pop(ENV_SEED, None)
        return install(None)
    inj = FaultInjector.parse(spec, seed=seed, journal=journal)
    if export_env:
        os.environ[ENV_SPEC] = spec
        os.environ[ENV_SEED] = str(seed)
    return install(inj)


def fire(point: str, stage: Optional[str] = None) -> None:
    """The hot-path hook: one global load and a None check when off."""
    inj = _INSTALLED
    if inj is not None:
        inj.fire(point, stage)


def transform(point: str, data: bytes) -> bytes:
    inj = _INSTALLED
    return data if inj is None else inj.transform(point, data)


# spawned processes inherit the spec through the environment
if knobs.get_str(ENV_SPEC):
    try:
        install_spec(knobs.get_str(ENV_SPEC), seed=knobs.get_int(ENV_SEED),
                     export_env=False)
    except (FaultSpecError, knobs.KnobError) as e:
        sys.stderr.write(f"faults: ignoring {ENV_SPEC}: {e}\n")
