"""Flight recorder: bounded-memory postmortem capture (the port of
deep_vision_tpu/obs/flight.py).

The journal explains a run that finished; this module explains a run
that died. A `FlightRecorder` keeps ring buffers (bounded memory, O(1)
an event) of the recent past:

  steps          the last N `step` journal rows
  health         recent health events (non_finite, spikes, hang dumps)
  journal tail   the last N journal rows of any type, in order
  notes          breadcrumbs from layers without a journal handle (the
                 data loader's worker restarts)
  span tail      taken from the active Tracer at dump time

and dumps them as an atomic, crc-checked bundle directory

  <flight_dir>/<run_id>-<reason>/
      MANIFEST.json     run identity, reason, each file's size and crc32
      journal_tail.jsonl  steps.jsonl  health.jsonl  notes.jsonl
      spans.json        Chrome-trace tail (loads in Perfetto)
      stacks.json       every Python thread's stack at dump time
      metrics.prom      the metrics registry, Prometheus text format

on each way a run dies:

  crash         the process exits without a clean close (atexit, armed)
  hang          the health watchdog fired (seen through the journal tap)
  health_abort  the HealthMonitor's abort policy tripped
  preempt       SIGTERM (multihost.PreemptionGuard, Server.drain)
  injected_crash[_after_write]  fault injection, dumped in the instants
                before its SIGKILL (faults.fire)

The bundle is written into `<final>.tmp-<pid>` with a per-file fsync,
then renamed: a reader never sees a half-written bundle, and a SIGKILL
mid-dump leaves only a `.tmp-` directory that `find_bundles` skips. A
prior run's bundle of the same name is never overwritten.

Idle cost: `observe` is a dict lookup and a deque append a journal
event; a layer with no recorder installed pays one module-global None
check in `note()`.

The requeue latch lives here too: a run preempted after its checkpoint
landed exits with `REQUEUE_EXIT_CODE` (75, EX_TEMPFAIL), so a scheduler
resubmits it instead of calling it finished (0) or failed (1).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional

from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.journal import _jsonable
from deep_vision_tpu_torch.obs.registry import process_index, process_suffix

#: the dump reasons check_journal validates; dump() accepts any string
#: (forward compat) but everything the repo emits is one of these
REASONS = (
    "crash",
    "hang",
    "health_abort",
    "preempt",
    "injected_crash",
    "injected_crash_after_write",
    "manual",
)

#: bundle payload files, in write order (MANIFEST.json is written last,
#: after every payload crc is known)
_PAYLOAD_FILES = (
    "journal_tail.jsonl",
    "steps.jsonl",
    "health.jsonl",
    "notes.jsonl",
    "spans.json",
    "stacks.json",
    "metrics.prom",
)


class FlightRecorder:
    """Bounded-memory black box for one run.

    Wire-up (what train_cli does):

        flight = FlightRecorder(flight_dir, run_id=journal.run_id)
        set_flight(flight)              # layers without a journal handle
        journal.add_tap(flight.observe) # feed the ring buffers
        ...
        flight.close()                  # clean exit: disarm, no dump

    Anything that dies in between leaves a bundle: the atexit hook dumps
    `crash` while armed, the journal tap dumps on hang/abort health
    events, and the preemption/fault hooks call `emergency_dump`.
    """

    def __init__(self, flight_dir: str, run_id: Optional[str] = None,
                 max_steps: int = 512, max_health: int = 256,
                 max_tail: int = 1024, max_notes: int = 256,
                 span_tail: int = 512, registry=None):
        self.flight_dir = flight_dir
        self.run_id = run_id or f"flight-{os.getpid()}-{int(time.time())}"
        self.span_tail = int(span_tail)
        self.registry = registry
        self.journal = None  # attach() wires the flight_dump event emitter
        self._steps: deque = deque(maxlen=int(max_steps))
        self._health: deque = deque(maxlen=int(max_health))
        self._tail: deque = deque(maxlen=int(max_tail))
        self._notes: deque = deque(maxlen=int(max_notes))
        self._lock = locksmith.lock("obs.flight")
        self._dumped: Dict[str, str] = {}  # reason -> bundle dir (latch)
        self._dumping = False
        self._armed = True
        self._closed = False
        atexit.register(self._atexit)

    # -- feeding the buffers ----------------------------------------------

    def attach(self, journal) -> None:
        """Tap `journal` and remember it for typed `flight_dump` events."""
        self.journal = journal
        journal.add_tap(self.observe)

    def observe(self, row: dict) -> None:
        """Journal tap: route one event row into the ring buffers, and
        trigger a dump when the row itself is the emergency (a watchdog
        hang dump, a health-abort verdict). A serve-plane abort
        (monitor="serve": the router fails one batch's requests and
        keeps answering — a canary rejecting poisoned weights is the
        designed outcome, not a death) is request-scoped by contract
        and must NOT leave a crash-grade postmortem."""
        ev = row.get("event")
        with self._lock:
            self._tail.append(row)
            if ev == "step":
                self._steps.append(row)
            elif ev == "health":
                self._health.append(row)
        if ev == "health" and not self._dumping:
            if row.get("kind") == "hang":
                self.dump("hang")
            elif row.get("action") == "abort" \
                    and row.get("monitor") != "serve":
                self.dump("health_abort")

    def note(self, category: str, **fields) -> None:
        """Breadcrumb from a layer without a journal handle (the data
        loader's worker restarts)."""
        row = {"ts": round(time.time(), 3), "category": str(category)}
        row.update({k: _jsonable(v) for k, v in fields.items()})
        with self._lock:
            self._notes.append(row)

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Write the postmortem bundle for `reason`; returns its path.

        Latched per reason: one stall produces one `hang` bundle, and the
        crash that may follow still gets its own `crash` bundle. A second
        dump for an already-dumped reason returns the existing path.
        """
        with self._lock:
            if reason in self._dumped:
                return self._dumped[reason]
            if self._dumping:
                return None  # a dump triggered from inside a dump
            self._dumping = True
            steps = list(self._steps)
            health = list(self._health)
            tail = list(self._tail)
            notes = list(self._notes)
        try:
            path = self._write_bundle(reason, steps, health, tail, notes)
            with self._lock:
                self._dumped[reason] = path
            self._journal_event(reason, path, outcome="written")
            return path
        except Exception as e:
            # the recorder must never turn a dying run into a different
            # death; the failed dump is itself journaled when possible
            self._journal_event(reason, self.flight_dir, outcome="failed",
                                error=f"{type(e).__name__}: {e}")
            return None
        finally:
            with self._lock:
                self._dumping = False

    def _journal_event(self, reason: str, path: str, outcome: str,
                       **extra) -> None:
        if self.journal is not None:
            try:
                self.journal.write("flight_dump", reason=reason, dir=path,
                                   outcome=outcome, **extra)
            except Exception:
                pass

    def _write_bundle(self, reason: str, steps, health, tail,
                      notes) -> str:
        # multi-process runs suffix the bundle name with '.pN' (the
        # journal/trace per-host contract): identically-launched hosts can
        # share run_id (pid + launch second), and a pod-wide preemption
        # dumping onto one shared flight dir must not race two hosts'
        # renames onto the same final path — the loser's bundle is exactly
        # the postmortem this module exists to keep
        base = f"{self.run_id}-{reason}{process_suffix()}"
        final = os.path.join(self.flight_dir, base)
        n = 2
        while os.path.exists(final):  # a prior run's bundle: never clobber
            final = os.path.join(self.flight_dir, f"{base}-{n}")
            n += 1
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)

        spans = self._span_tail()
        stacks = _all_stacks()
        metrics = self._metrics_text()
        payloads = {
            "journal_tail.jsonl": _jsonl(tail),
            "steps.jsonl": _jsonl(steps),
            "health.jsonl": _jsonl(health),
            "notes.jsonl": _jsonl(notes),
            "spans.json": json.dumps({"traceEvents": spans,
                                      "metadata": {"run_id": self.run_id}}),
            "stacks.json": json.dumps(stacks, indent=1),
            "metrics.prom": metrics,
        }
        files: Dict[str, dict] = {}
        for name in _PAYLOAD_FILES:
            data = payloads[name].encode()
            files[name] = {"bytes": len(data), "crc32": zlib.crc32(data)}
            _write_fsync(os.path.join(tmp, name), data)
        manifest = {
            "run_id": self.run_id,
            "reason": reason,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "process_index": process_index(),
            "files": files,
        }
        _write_fsync(os.path.join(tmp, "MANIFEST.json"),
                     json.dumps(manifest, indent=1).encode())
        os.rename(tmp, final)
        _fsync_dir(self.flight_dir)
        return final

    def _span_tail(self) -> List[dict]:
        try:
            from deep_vision_tpu_torch.obs.trace import get_tracer

            t = get_tracer()
            return t.tail(self.span_tail) if t is not None else []
        except Exception:
            return []

    def _metrics_text(self) -> str:
        try:
            reg = self.registry
            if reg is None:
                from deep_vision_tpu_torch.obs.registry import get_registry

                reg = get_registry()
            return reg.to_prometheus()
        except Exception:
            return ""

    # -- lifecycle ---------------------------------------------------------

    @property
    def dumped(self) -> Dict[str, str]:
        """reason -> bundle path for every dump this run produced."""
        with self._lock:
            return dict(self._dumped)

    def disarm(self) -> None:
        """A clean exit is not an emergency: no crash bundle at atexit."""
        self._armed = False

    def close(self) -> None:
        """Clean-exit epilogue: disarm and detach (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self.disarm()
        atexit.unregister(self._atexit)
        if get_flight() is self:
            set_flight(None)

    def _atexit(self) -> None:
        if self._armed:
            self.dump("crash")


# -- bundle validation --------------------------------------------------------

def validate_bundle(path: str) -> List[str]:
    """Structural and crc validation of one bundle dir; an empty list
    means valid: the manifest must parse and carry the envelope, and
    every listed file must exist with the recorded size and crc32, so a
    torn or rotted bundle fails loudly.
    """
    errors: List[str] = []
    man_path = os.path.join(path, "MANIFEST.json")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{man_path}: unreadable manifest: {e}"]
    for k in ("run_id", "reason", "ts", "files"):
        if k not in manifest:
            errors.append(f"{man_path}: missing field {k!r}")
    for name, meta in (manifest.get("files") or {}).items():
        fpath = os.path.join(path, name)
        try:
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError as e:
            errors.append(f"{fpath}: listed in manifest but unreadable: {e}")
            continue
        if len(data) != meta.get("bytes"):
            errors.append(f"{fpath}: size {len(data)} != manifest "
                          f"{meta.get('bytes')}")
        if zlib.crc32(data) != meta.get("crc32"):
            errors.append(f"{fpath}: crc32 mismatch (bundle rotted or torn)")
    return errors


def find_bundles(flight_dir: str) -> List[str]:
    """Complete bundle dirs under `flight_dir` (in-flight `.tmp-` dirs and
    stray files are excluded), sorted by name."""
    try:
        entries = sorted(os.listdir(flight_dir))
    except OSError:
        return []
    out = []
    for e in entries:
        full = os.path.join(flight_dir, e)
        if os.path.isdir(full) and ".tmp-" not in e:
            out.append(full)
    return out


# -- preemption escalation: checkpoint-now-and-requeue ------------------------

#: exit code a preempted run returns after its checkpoint landed:
#: EX_TEMPFAIL, the conventional "transient failure — requeue me" code
#: (sendmail, SLURM requeue policies). Distinct from 0 (done, do not
#: reschedule) and 1 (bug, do not reschedule), so the scheduler that
#: SIGTERMed the VM can resubmit the job to resume from the preempt
#: checkpoint.
REQUEUE_EXIT_CODE = 75

_requeue_requested = False


def request_requeue() -> None:
    """Mark this run preempted-with-checkpoint: the CLI exits with
    `REQUEUE_EXIT_CODE` so the scheduler requeues instead of declaring the
    job finished or failed. Called by the Trainer's SIGTERM escalation
    after the preempt checkpoint is on disk (the flight `preempt` bundle
    was already dumped from the signal hook)."""
    global _requeue_requested
    _requeue_requested = True


def requeue_requested() -> bool:
    return _requeue_requested


def clear_requeue() -> None:
    """Reset the latch (CLI entry, tests): the flag is process-wide and a
    long-lived process may host several runs."""
    global _requeue_requested
    _requeue_requested = False


# -- process-wide active recorder ---------------------------------------------

_active: Optional[FlightRecorder] = None


def set_flight(recorder: Optional[FlightRecorder]) -> None:
    """Install (or clear, with None) the process-wide recorder that the
    module-level `note`/`emergency_dump` report to."""
    global _active
    _active = recorder


def get_flight() -> Optional[FlightRecorder]:
    return _active


def note(category: str, **fields) -> None:
    """Breadcrumb on the active recorder; one global load + None check
    when no recorder is installed (same contract as trace.span)."""
    fr = _active
    if fr is not None:
        fr.note(category, **fields)


def emergency_dump(reason: str) -> Optional[str]:
    """Dump the active recorder's bundle NOW (fault injection's pre-SIGKILL
    hook, the preemption guard's SIGTERM hook); no-op without a recorder."""
    fr = _active
    if fr is not None:
        return fr.dump(reason)
    return None


# -- small helpers ------------------------------------------------------------

def _jsonl(rows: List[dict]) -> str:
    return "".join(json.dumps(r) + "\n" for r in rows)


def _all_stacks() -> dict:
    try:
        from deep_vision_tpu_torch.obs.health import dump_all_stacks

        return dump_all_stacks()
    except Exception:
        return {}


def _write_fsync(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Durability for the rename itself (the SIGKILL may be microseconds
    away on the injected-crash path)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass
