"""The port's lock sanitizer (deep_vision_tpu_torch/obs/locksmith.py)
against the JAX package's.

The same acquisition scripts, run under each package's armed
Sanitizer with each package's locks, journal the same
`lock_order_violation` and `lock_contention` rows (stacks, thread ids
and milliseconds masked) and report the same per-lock counts. Also: a
condition wait releases the lock for the sanitizer, the disarmed
report, knob parsing, and pickling of locks (the reentrant kind stays
reentrant) and of the feed's BadRecordBudget.
"""
import json
import pickle
import threading
import time

import numpy as np
import pytest

from deep_vision_tpu.core import knobs as ref_knobs
from deep_vision_tpu.obs import locksmith as ref_locksmith
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu_torch.core import knobs
from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.registry import Registry

#: a hold or wait this long is flagged; the scripts' long ones are 3x it
#: and their short ones hold no sleep
THRESHOLD_MS = 200.0
LONG_S = 0.5


class Rows:
    """A journal that keeps what it is given."""

    def __init__(self):
        self.rows = []

    def write(self, event, **fields):
        self.rows.append(dict(fields, event=event))


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    locksmith.disarm()
    ref_locksmith.disarm()


def run_in(name, fn):
    t = threading.Thread(target=fn, name=name)
    t.start()
    t.join()


def script(mod, seed):
    """Lock traffic from a seed: threads (one after another) take random
    nested pairs of four roles (their inversions are the seed's); then
    an inversion is planted, a long hold, a contended acquire, a
    condition wait and a reentrant nest."""
    rng = np.random.RandomState(seed)
    locks = {n: mod.lock(n) for n in "abcdefgh"}
    for k in range(8):
        order = [str(x) for x in rng.permutation(list("efgh"))[:2]]

        def nested(order=order):
            with locks[order[0]]:
                with locks[order[1]]:
                    pass

        run_in(f"t{k}", nested)

    def ab():
        with locks["a"]:
            with locks["b"]:
                pass

    def ba():
        with locks["b"]:
            with locks["a"]:
                pass

    run_in("first", ab)
    run_in("second", ba)  # the inversion, flagged once per pair
    run_in("third", ba)

    def long_hold():
        with locks["c"]:
            time.sleep(LONG_S)

    run_in("holder", long_hold)

    held = threading.Event()
    release = threading.Event()

    def hold_d():  # twice c's hold: d is the longest hold in any run
        with locks["d"]:
            held.set()
            release.wait(10)
            time.sleep(2 * LONG_S)

    def wait_d():
        held.wait(10)
        release.set()
        with locks["d"]:
            pass

    h = threading.Thread(target=hold_d, name="d-holder")
    w = threading.Thread(target=wait_d, name="d-waiter")
    h.start()
    w.start()
    h.join()
    w.join()

    cond = mod.condition("cv")
    flag = []
    ready = threading.Event()

    def waiter():
        with cond:
            ready.set()  # held until wait() releases it
            while not flag:
                cond.wait(timeout=30)

    t = threading.Thread(target=waiter, name="cv-waiter")
    t.start()
    ready.wait(10)
    time.sleep(LONG_S)  # the waiter sleeps inside wait(): not a hold
    with cond:
        flag.append(1)
        cond.notify_all()
    t.join()

    r = mod.rlock("r")

    def reentrant():
        with r:
            with r:
                with locks["a"]:
                    pass

    run_in("reentrant", reentrant)


def masked_rows(rows):
    """Rows with stacks and milliseconds masked, in a canonical order:
    the d-holder's hold row and the d-waiter's wait row are queued by two
    threads at once."""
    out = []
    for row in rows:
        row = dict(row)
        for k in ("stack", "prior_stack", "site"):
            if k in row:
                assert row.pop(k) is not None
        if "ms" in row:
            assert row.pop("ms") > THRESHOLD_MS
        out.append(row)
    return sorted(out, key=lambda r: json.dumps(r, sort_keys=True))


def masked_report(rep):
    locks = {name: {k: v for k, v in st.items() if not k.endswith("_ms")}
             for name, st in rep["locks"].items()}
    return {"armed": rep["armed"], "locks": locks,
            "violations": masked_rows(rep["violations"]),
            "top_contended": rep["top_contended"],
            "max_hold_lock": rep["max_hold_lock"]}


@pytest.mark.parametrize("seed", [0, 1])
def test_same_script_same_rows(seed):
    got = {}
    for mod, reg in ((locksmith, Registry), (ref_locksmith, RefRegistry)):
        journal = Rows()
        registry = reg()
        san = mod.arm(journal=journal, registry=registry,
                      hold_ms=THRESHOLD_MS, wait_ms=THRESHOLD_MS)
        script(mod, seed)
        rep = mod.report()
        mod.disarm()
        assert mod.get_sanitizer() is None and san.report()["armed"] is \
            False
        got[mod.__name__] = (masked_rows(journal.rows), masked_report(rep),
                             registry.counter(
                                 "locksmith_order_violations_total").value)
    port, ref = got["deep_vision_tpu_torch.obs.locksmith"], \
        got["deep_vision_tpu.obs.locksmith"]
    assert port == ref
    rows, rep, n_violations = port
    assert n_violations == sum(r["event"] == "lock_order_violation"
                               for r in rows) >= 1
    events = [(r["event"], r.get("lock_a"), r.get("lock_b"), r.get("lock"),
               r.get("kind")) for r in rows]
    assert ("lock_order_violation", "b", "a", None, None) in events
    assert ("lock_contention", None, None, "c", "hold") in events
    assert ("lock_contention", None, None, "d", "wait") in events
    assert not any(r.get("lock") == "cv" for r in rows)
    (v,) = [r for r in rows if r["event"] == "lock_order_violation"
            and r["lock_a"] in "ab"]
    assert v["thread"] == "second" and v["prior_thread"] == "first"
    assert rep["max_hold_lock"] == rep["top_contended"] == "d"
    assert rep["locks"]["cv"]["acquisitions"] == 3


def test_disarmed_report_and_no_cost_path():
    assert locksmith.get_sanitizer() is None
    assert locksmith.report() == ref_locksmith.report()
    lk = locksmith.lock("x")
    assert lk.acquire() and lk.locked()
    lk.release()
    assert not lk.locked()
    assert lk.acquire(blocking=False)
    assert not lk.acquire(blocking=False)
    lk.release()
    assert repr(lk) == "InstrumentedLock('x')"


def test_arm_from_env_reads_the_knobs(monkeypatch):
    monkeypatch.delenv("DVT_LOCKSMITH", raising=False)
    assert locksmith.arm_from_env() is None
    monkeypatch.setenv("DVT_LOCKSMITH", "1")
    monkeypatch.setenv("DVT_LOCKSMITH_HOLD_MS", "25.5")
    san = locksmith.arm_from_env(registry=Registry())
    assert san is locksmith.get_sanitizer()
    assert san.hold_ms == 25.5 and san.wait_ms == 1000.0
    locksmith.disarm()
    monkeypatch.setenv("DVT_LOCKSMITH_HOLD_MS", "soon")
    with pytest.raises(knobs.KnobError):
        locksmith.arm_from_env(registry=Registry())
    monkeypatch.setenv("DVT_LOCKSMITH", "maybe")
    with pytest.raises(knobs.KnobError):
        locksmith.arm_from_env(registry=Registry())
    for name in ("DVT_LOCKSMITH", "DVT_LOCKSMITH_HOLD_MS",
                 "DVT_LOCKSMITH_WAIT_MS"):
        assert knobs.KNOBS[name].default == ref_knobs.KNOBS[name].default
        assert knobs.KNOBS[name].kind == ref_knobs.KNOBS[name].kind


def test_locks_pickle_with_their_reentrancy():
    for make, reentrant in ((locksmith.lock, False),
                            (locksmith.rlock, True)):
        lk = make("p")
        lk.acquire()
        copy = pickle.loads(pickle.dumps(lk))
        lk.release()
        assert copy.name == "p" and not copy.locked()
        assert copy.acquire()
        assert copy.acquire(blocking=False) is reentrant
        copy.release()
        if reentrant:
            copy.release()
    from deep_vision_tpu_torch.data.records import BadRecordBudget

    budget = BadRecordBudget(max_count=3)
    copy = pickle.loads(pickle.dumps(budget))
    assert isinstance(copy._lock, locksmith.InstrumentedLock)
    assert copy._lock.name == "data.records.budget"
    assert copy.max_count == 3


def test_condition_wait_is_not_a_hold_and_counts_acquisitions():
    journal = Rows()
    locksmith.arm(journal=journal, registry=Registry(), hold_ms=50.0,
                  wait_ms=50.0)
    cond = locksmith.condition("q")
    with cond:
        assert cond.wait(timeout=0.2) is False
        assert cond.wait_for(lambda: True, timeout=1) is True
    rep = locksmith.report()
    locksmith.disarm()
    assert journal.rows == []
    assert rep["locks"]["q"]["acquisitions"] == 3  # enter + two re-acquires
    assert rep["locks"]["q"]["hold_contentions"] == 0
