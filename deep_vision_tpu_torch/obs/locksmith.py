"""locksmith: an opt-in runtime lock-order sanitizer (the port of
deep_vision_tpu/obs/locksmith.py).

It catches what a review of one module cannot: lock orders across
modules (the Server's device lock against the journal's lock and the
flight recorder's ring) and hold-time outliers under real traffic, the
way lockdep does for a kernel. Adoption is a swap at the construction
site:

    self._lock = locksmith.lock("serve.device")       # was threading.Lock()
    self._cond = locksmith.condition("serve.queue")   # was threading.Condition()

Every `with self._lock:` / `acquire()` / `release()` / `wait()` keeps
working. Disarmed (the default), each operation pays one module-global
load and None check on top of the raw primitive.

Armed (`locksmith.arm(journal=...)`, or `DVT_LOCKSMITH=1` read by
`arm_from_env` at train_cli start-up), the sanitizer keeps a per-thread
stack of held locks (name and acquisition site) and:

  - records every held -> acquired edge in a global lock-order graph;
    the first time an edge's REVERSE is already present, two threads
    taking the opposite paths can deadlock, and a typed
    `lock_order_violation` journal event carries both acquisition
    stacks (`locksmith_order_violations_total` counts them);
  - flags hold-time and acquire-wait outliers over `hold_ms` / `wait_ms`
    as typed `lock_contention` events (`kind: hold | wait`), with
    per-lock max-hold and contention stats in `report()`.

The sanitizer must not deadlock itself: journal.write takes the
journal's own (instrumented) lock, so events are queued at detection
time and flushed only when the detecting thread holds no instrumented
lock (its next full release, or `disarm()`). A thread-local latch keeps
the flush's own lock traffic out of the graph.

Same-name lock instances (every BatchingQueue's condition is
"serve.queue") are one node of the graph, like lockdep's lock classes:
ordering is checked between lock roles, and nested same-name
acquisition counts as reentrant rather than as a self-cycle.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deep_vision_tpu_torch.core import knobs

#: env switch for subprocess runs: a true flag value arms at train_cli
#: start-up; the thresholds override the defaults
ENV_ARM = "DVT_LOCKSMITH"
ENV_HOLD_MS = "DVT_LOCKSMITH_HOLD_MS"
ENV_WAIT_MS = "DVT_LOCKSMITH_WAIT_MS"

DEFAULT_HOLD_MS = 1000.0
DEFAULT_WAIT_MS = 1000.0
_STACK_DEPTH = 8

_active: Optional["Sanitizer"] = None


class Sanitizer:
    """Process-wide lock-order/contention monitor (install via arm())."""

    def __init__(self, journal=None, registry=None,
                 hold_ms: float = DEFAULT_HOLD_MS,
                 wait_ms: float = DEFAULT_WAIT_MS,
                 stack_depth: int = _STACK_DEPTH):
        self.journal = journal
        self.hold_ms = float(hold_ms)
        self.wait_ms = float(wait_ms)
        self.stack_depth = int(stack_depth)
        self._tls = threading.local()
        # RAW lock, never instrumented: guards the graph + stats; leaf by
        # construction (nothing is called while holding it)
        self._mu = threading.Lock()
        self._edges: Dict[tuple, dict] = {}  # (a, b) -> first-seen site
        self._flagged: set = set()  # frozenset({a, b}) latch per pair
        self._violations: List[dict] = []
        self._stats: Dict[str, dict] = {}  # name -> acquisition stats
        self._pending: deque = deque()  # journal rows awaiting a safe point
        if registry is None:
            from deep_vision_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._c_violations = registry.counter(
            "locksmith_order_violations_total",
            "runtime lock-order inversions detected")
        self._c_contention = {
            kind: registry.counter(
                "locksmith_contention_total",
                "lock holds/waits over the configured threshold",
                labels={"kind": kind})
            for kind in ("hold", "wait")}

    # -- per-thread bookkeeping -------------------------------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _in_emit(self) -> bool:
        return getattr(self._tls, "in_emit", False)

    def _site(self) -> List[str]:
        # skip the sanitizer + wrapper frames (this one, acquired() and the
        # wrapper's acquire) and keep the caller's tail, oldest first;
        # walked by hand: traceback.extract_stack reads every frame's
        # source line, which the site does not show
        frame = sys._getframe(3)
        site = []
        while frame is not None and len(site) < self.stack_depth:
            code = frame.f_code
            site.append(f"{code.co_filename}:{frame.f_lineno} in "
                        f"{code.co_name}")
            frame = frame.f_back
        return site[::-1]

    def _stat(self, name: str) -> dict:
        s = self._stats.get(name)
        if s is None:
            s = self._stats[name] = {
                "acquisitions": 0, "max_hold_ms": 0.0, "max_wait_ms": 0.0,
                "hold_contentions": 0, "wait_contentions": 0}
        return s

    # -- wrapper hooks -----------------------------------------------------

    def acquired(self, name: str, wait_s: float) -> None:
        """Called by a wrapper AFTER its raw acquire succeeded."""
        if self._in_emit():
            return
        held = self._held()
        for i, entry in enumerate(held):
            if entry[0] == name:
                # same lock class re-entered (RLock, or a sibling instance
                # sharing the role name): count, no self-edge
                held[i] = (name, entry[1], entry[2], entry[3] + 1)
                return
        site = self._site()
        wait_ms = wait_s * 1e3
        with self._mu:
            st = self._stat(name)
            st["acquisitions"] += 1
            if wait_ms > st["max_wait_ms"]:
                st["max_wait_ms"] = wait_ms
            slow_wait = wait_ms > self.wait_ms
            if slow_wait:
                st["wait_contentions"] += 1
            violation = None
            for h, _, h_site, _ in held:
                edge = (h, name)
                if edge not in self._edges:
                    self._edges[edge] = {
                        "thread": threading.current_thread().name,
                        "stack": site, "held_at": list(h_site)}
                rev = self._edges.get((name, h))
                pair = frozenset((h, name))
                if rev is not None and pair not in self._flagged:
                    self._flagged.add(pair)
                    violation = {
                        "lock_a": h, "lock_b": name,
                        "thread": threading.current_thread().name,
                        "stack": site,
                        "prior_thread": rev["thread"],
                        "prior_stack": rev["stack"],
                    }
                    self._violations.append(violation)
        if slow_wait:
            self._c_contention["wait"].inc()
            self._queue_row("lock_contention", lock=name, kind="wait",
                            ms=round(wait_ms, 3),
                            threshold_ms=self.wait_ms,
                            thread=threading.current_thread().name)
        if violation is not None:
            self._c_violations.inc()
            self._queue_row("lock_order_violation", **violation)
        held.append((name, time.perf_counter(), site, 1))

    def released(self, name: str, flush: bool = True) -> None:
        """Called by a wrapper AFTER its raw release (so a flush here can
        re-acquire the very lock just released, e.g. the journal's)."""
        if self._in_emit():
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                nm, t0, site, count = held[i]
                if count > 1:
                    held[i] = (nm, t0, site, count - 1)
                    return
                del held[i]
                hold_ms = (time.perf_counter() - t0) * 1e3
                with self._mu:
                    st = self._stat(name)
                    if hold_ms > st["max_hold_ms"]:
                        st["max_hold_ms"] = hold_ms
                    slow = hold_ms > self.hold_ms
                    if slow:
                        st["hold_contentions"] += 1
                if slow:
                    self._c_contention["hold"].inc()
                    self._queue_row(
                        "lock_contention", lock=name, kind="hold",
                        ms=round(hold_ms, 3), threshold_ms=self.hold_ms,
                        thread=threading.current_thread().name,
                        site=site[-1] if site else "")
                break
        if flush and not held:
            self.flush_pending()

    # -- emission ----------------------------------------------------------

    def _queue_row(self, event: str, **fields) -> None:
        if self.journal is not None:
            self._pending.append((event, fields))

    def flush_pending(self) -> None:
        """Write queued events; only call while holding no instrumented
        locks (end-of-release safe point, or disarm())."""
        if self.journal is None or not self._pending:
            return
        self._tls.in_emit = True
        try:
            while True:
                try:
                    event, fields = self._pending.popleft()
                except IndexError:
                    break
                try:
                    # every row was queued by _queue_row with a typed
                    # event: lock_order_violation or lock_contention
                    self.journal.write(event, **fields)
                except Exception:
                    pass  # the sanitizer must never kill what it watches
        finally:
            self._tls.in_emit = False

    # -- reading back ------------------------------------------------------

    def violations(self) -> List[dict]:
        with self._mu:
            return list(self._violations)

    def report(self) -> dict:
        """{violations, locks: {name: stats}, top_contended, max_hold_ms,
        max_hold_lock}: the lock-health summary a run checks."""
        with self._mu:
            locks = {k: dict(v) for k, v in self._stats.items()}
            violations = list(self._violations)
        top = None
        worst = (0, 0.0)
        max_hold = ("", 0.0)
        for name, st in locks.items():
            score = (st["hold_contentions"] + st["wait_contentions"],
                     st["max_wait_ms"] + st["max_hold_ms"])
            if score > worst:
                worst, top = score, name
            if st["max_hold_ms"] > max_hold[1]:
                max_hold = (name, st["max_hold_ms"])
        return {
            "armed": _active is self,
            "violations": violations,
            "locks": locks,
            "top_contended": top if worst[0] > 0 else None,
            "max_hold_lock": max_hold[0] or None,
            "max_hold_ms": round(max_hold[1], 3),
        }


# -- instrumented primitives --------------------------------------------------

class InstrumentedLock:
    """threading.Lock with a role name, observable by the armed sanitizer.

    Picklable (data-loader worker processes receive copies of objects
    holding one): the raw lock is recreated on unpickle, as
    data/records.py's BadRecordBudget recreates its own.
    """

    __slots__ = ("name", "_lk", "_reentrant")

    def __init__(self, name: str, raw=None, reentrant: bool = False):
        self.name = name
        self._reentrant = reentrant
        if raw is None:
            raw = threading.RLock() if reentrant else threading.Lock()
        self._lk = raw

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        san = _active
        if san is None:
            return self._lk.acquire(blocking, timeout)
        t0 = time.perf_counter()
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            san.acquired(self.name, time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._lk.release()
        san = _active
        if san is not None:
            san.released(self.name)

    def locked(self) -> bool:
        fn = getattr(self._lk, "locked", None)  # RLock lacks it pre-3.13
        return bool(fn()) if fn is not None else False

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False

    def __getstate__(self):
        return {"name": self.name, "reentrant": self._reentrant}

    def __setstate__(self, state):
        # the raw primitive is recreated with its original reentrancy: an
        # rlock that unpickled as a plain Lock would self-deadlock in the
        # worker on the first nested acquire
        self.name = state["name"]
        self._reentrant = state.get("reentrant", False)
        self._lk = (threading.RLock() if self._reentrant
                    else threading.Lock())

    def __repr__(self) -> str:
        return f"InstrumentedLock({self.name!r})"


class InstrumentedCondition:
    """threading.Condition with a role name.

    `wait()` logically releases the lock for its duration — the sanitizer
    is told, so a dispatcher parked on an empty queue neither shows up as
    a marathon hold nor contributes phantom ordering edges while asleep.

    Known blind spot: the re-acquire after a wakeup is recorded with
    wait_s=0 — threading.Condition gives no handle on how much of wait()
    was sleep vs re-acquire contention, so `kind=wait` contention on a
    condition's lock is only measured for explicit acquire()/`with`
    entries, not the post-notify stampede. Hold times and ordering are
    unaffected.
    """

    __slots__ = ("name", "_cv")

    def __init__(self, name: str, lock=None):
        self.name = name
        self._cv = threading.Condition(lock)

    def acquire(self, *args) -> bool:
        san = _active
        if san is None:
            return self._cv.acquire(*args)
        t0 = time.perf_counter()
        ok = self._cv.acquire(*args)
        if ok:
            san.acquired(self.name, time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._cv.release()
        san = _active
        if san is not None:
            # no flush here: we may be between a wait() and its caller's
            # own critical-section logic; the next lock-free release or
            # disarm() drains
            san.released(self.name, flush=False)

    def wait(self, timeout: Optional[float] = None) -> bool:
        san = _active
        if san is not None:
            san.released(self.name, flush=False)
        try:
            return self._cv.wait(timeout)
        finally:
            san = _active
            if san is not None:
                san.acquired(self.name, 0.0)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        san = _active
        if san is not None:
            san.released(self.name, flush=False)
        try:
            return self._cv.wait_for(predicate, timeout)
        finally:
            san = _active
            if san is not None:
                san.acquired(self.name, 0.0)

    def notify(self, n: int = 1) -> None:
        self._cv.notify(n)

    def notify_all(self) -> None:
        self._cv.notify_all()

    def __enter__(self) -> "InstrumentedCondition":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"InstrumentedCondition({self.name!r})"


# -- module API ----------------------------------------------------------------

def lock(name: str) -> InstrumentedLock:
    """A named mutex; drop-in for threading.Lock() at construction."""
    return InstrumentedLock(name)


def rlock(name: str) -> InstrumentedLock:
    """A named reentrant mutex (the sanitizer treats same-name nesting as
    reentrant either way; the raw primitive must still allow it, and the
    reentrancy survives pickling into worker processes)."""
    return InstrumentedLock(name, reentrant=True)


def condition(name: str) -> InstrumentedCondition:
    """A named condition variable; drop-in for threading.Condition()."""
    return InstrumentedCondition(name)


def arm(journal=None, registry=None, hold_ms: float = DEFAULT_HOLD_MS,
        wait_ms: float = DEFAULT_WAIT_MS) -> Sanitizer:
    """Install (and return) the process-wide sanitizer. Idempotent-ish:
    arming replaces any previous sanitizer (its findings stay readable
    via the returned handle)."""
    global _active
    san = Sanitizer(journal=journal, registry=registry, hold_ms=hold_ms,
                    wait_ms=wait_ms)
    _active = san
    return san


def arm_from_env(journal=None, registry=None) -> Optional[Sanitizer]:
    """Arm when DVT_LOCKSMITH is set (subprocess runs); no-op and None
    otherwise. Threshold knobs follow the mistype-raises
    convention: DVT_LOCKSMITH_HOLD_MS=soon must fail loudly here, not
    silently sanitize with a garbage threshold (or crash later)."""
    if not knobs.get_flag(ENV_ARM):
        return None
    return arm(journal=journal, registry=registry,
               hold_ms=knobs.get_float(ENV_HOLD_MS, DEFAULT_HOLD_MS),
               wait_ms=knobs.get_float(ENV_WAIT_MS, DEFAULT_WAIT_MS))


def disarm() -> None:
    """Uninstall and flush any queued journal rows."""
    global _active
    san, _active = _active, None
    if san is not None:
        san.flush_pending()


def get_sanitizer() -> Optional[Sanitizer]:
    return _active


def report() -> dict:
    """The active sanitizer's report(), or a disarmed placeholder."""
    san = _active
    if san is None:
        return {"armed": False, "violations": [], "locks": {},
                "top_contended": None, "max_hold_lock": None,
                "max_hold_ms": 0.0}
    return san.report()
