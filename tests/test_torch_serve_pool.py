"""The port's fleet layer (serve/admission.py, serve/pool.py) against the
JAX package's, mirroring tests/test_serve_pool.py's classes on its toy
predictor, which carries across to torch as is.

Admission is pure host code, so the two packages' token buckets and
controllers are driven with one injected clock and the same seeded
arrivals and must give the same verdicts. The pool runs the port's toy
on the CPU: routing spreads over the replicas, a `serve.replica` death
fails only the requests on the dead replica and the respawn recovers
(also after a failed respawn attempt), the drain's ledger balances
across respawns, all replicas down refuses with a counted `refused`,
racing clients respect the queue bound, the armed lock sanitizer sees no
violation, and `tools/check_journal.py --strict` accepts the port's
fleet journal and rejects the same bad enums as the reference's.
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deep_vision_tpu.resilience import faults as ref_faults
from deep_vision_tpu.serve import AdmissionController as RefAdmission
from deep_vision_tpu.serve import TokenBucket as RefTokenBucket
from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.obs.telemetry import TelemetryServer
from deep_vision_tpu_torch.resilience import RetryPolicy, faults
from deep_vision_tpu_torch.serve import (
    REPLICA_STATES,
    SHED_REASONS,
    AdmissionController,
    Engine,
    ReplicaLost,
    ReplicaPool,
    ServeError,
    ShedError,
    TokenBucket,
)
from deep_vision_tpu_torch.serve.engine import warmup_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.check_journal import check_journal  # noqa: E402

IMG = (4, 4, 1)


def toy_fn(variables, images):
    flat = images.reshape(images.shape[0], -1)
    return {"scores": flat @ variables["w"],
            "mean": images.mean(dim=(1, 2, 3))}


def toy_variables(scale=1.0, seed=0):
    w = np.random.RandomState(seed).randn(16, 3).astype(np.float32) * scale
    return {"w": torch.from_numpy(w)}


def images(n, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.rand(*IMG).astype(np.float32) for _ in range(n)]


def build_engine_factory(registry, buckets=(1, 2, 4)):
    def build(rid):
        eng = Engine(device="cpu", registry=registry)
        eng.register("toy", toy_fn, toy_variables(), input_shape=IMG,
                     buckets=buckets)
        return eng

    return build


def make_pool(journal=None, replicas=2, registry=None, **kw):
    registry = registry or Registry()
    kw.setdefault("max_wait_ms", 3.0)
    return ReplicaPool(build_engine_factory(registry), replicas=replicas,
                       journal=journal, registry=registry, **kw).start()


def wait_all_serving(pool, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(s == "serving" for s in pool.replica_states().values()):
            return True
        time.sleep(0.02)
    return False


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faults, ref_faults):
        mod.install(None)
        os.environ.pop(mod.ENV_SPEC, None)
        os.environ.pop(mod.ENV_SEED, None)
    locksmith.disarm()


@pytest.fixture
def journal(tmp_path):
    j = RunJournal(str(tmp_path / "fleet.jsonl"), kind="serve")
    j.manifest()
    yield j
    if not j._closed:
        j.close()


def events(path, name):
    return [e for e in read_journal(path) if e.get("event") == name]


# -- admission ---------------------------------------------------------------

class TestAdmission:
    @pytest.mark.parametrize("cls", [TokenBucket, RefTokenBucket],
                             ids=["port", "reference"])
    def test_token_bucket_refill_math(self, cls):
        t = {"now": 0.0}
        b = cls(rate_per_s=2.0, burst=3, clock=lambda: t["now"])
        assert [b.take() for _ in range(4)] == [True, True, True, False]
        t["now"] = 0.5  # one token refilled
        assert b.take() and not b.take()
        t["now"] = 100.0  # refill caps at burst
        assert [b.take() for _ in range(4)] == [True, True, True, False]

    def test_zero_rate_bucket_never_refills(self):
        b = TokenBucket(rate_per_s=0.0, burst=2, clock=lambda: 0.0)
        assert b.take() and b.take() and not b.take()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_verdicts_as_the_reference(self, seed):
        # one clock, the same seeded arrivals (times, models, the depth
        # each was judged at) through both controllers, a draining tail
        rng = np.random.RandomState(seed)
        t = {"now": 0.0}
        port = AdmissionController(max_queue_depth=6, rate_per_s=40.0,
                                   burst=5, clock=lambda: t["now"])
        ref = RefAdmission(max_queue_depth=6, rate_per_s=40.0, burst=5,
                           clock=lambda: t["now"])
        got, want = [], []
        for i in range(400):
            t["now"] += float(rng.exponential(1 / 240.0))
            model = ("yolo", "pose", "centernet")[rng.randint(3)]
            depth = int(rng.randint(0, 9))
            if i == 350:
                port.start_draining()
                ref.start_draining()
            got.append(port.admit(model, depth))
            want.append(ref.admit(model, depth))
        assert got == want
        assert {"queue_full", "rate_limited", "draining", None} <= set(got)

    def test_queue_bound_precedes_rate_budget(self):
        adm = AdmissionController(max_queue_depth=2, rate_per_s=0.0, burst=1)
        assert adm.admit("toy", queue_depth=2) == "queue_full"
        assert adm.admit("toy", queue_depth=0) is None  # token spent here
        assert adm.admit("toy", queue_depth=0) == "rate_limited"

    def test_draining_sheds_everything(self):
        adm = AdmissionController(max_queue_depth=8)
        assert adm.admit("toy", 0) is None
        adm.start_draining()
        assert adm.admit("toy", 0) == "draining"

    def test_enums_are_the_reference_and_schema_ones(self):
        from deep_vision_tpu.serve import REPLICA_STATES as REF_STATES
        from deep_vision_tpu.serve import SHED_REASONS as REF_REASONS
        from tools.check_journal import SERVE_SHED_REASONS

        assert SHED_REASONS == REF_REASONS
        assert set(SHED_REASONS) == SERVE_SHED_REASONS
        assert REPLICA_STATES == REF_STATES

    def test_rejects_garbage(self):
        with pytest.raises(ValueError):
            AdmissionController(max_queue_depth=0)
        with pytest.raises(ValueError):
            TokenBucket(rate_per_s=1.0, burst=0)
        with pytest.raises(ValueError):
            TokenBucket(rate_per_s=-1.0, burst=1)


# -- pool routing + accounting -----------------------------------------------

class TestPoolRouting:
    def test_traffic_spreads_across_replicas(self, journal):
        pool = make_pool(journal=journal, replicas=2)
        try:
            ims = images(16)
            futs = [pool.submit("toy", im) for im in ims]
            want = toy_fn(toy_variables(), torch.from_numpy(np.stack(ims)))
            for i, f in enumerate(futs):
                np.testing.assert_allclose(f.result(timeout=30)["scores"],
                                           want["scores"][i].numpy(),
                                           rtol=1e-6)
        finally:
            pool.close()
        journal.close()
        replicas = {e.get("replica")
                    for e in events(journal.path, "serve_request")}
        assert replicas == {"r0", "r1"}
        assert check_journal(journal.path, strict=True) == []

    def test_pool_drain_aggregates_the_fleet_ledger(self, journal):
        pool = make_pool(journal=journal, replicas=2)
        for f in [pool.submit("toy", im) for im in images(6)]:
            f.result(timeout=30)
        summary = pool.drain("close")
        assert summary["outcome"] == "flushed"
        assert summary["accepted"] == 6 and summary["completed"] == 6
        assert summary["offered"] == 6 and summary["shed"] == 0
        assert summary["replicas"] == 2
        assert pool.drain("close") is summary  # idempotent
        journal.close()
        drains = events(journal.path, "serve_drain")
        assert len(drains) == 3  # r0, r1, then the pool's
        assert drains[-1]["scope"] == "pool"
        (warm,) = [e for e in events(journal.path, "note")
                   if e["note"] == "pool_warmup"]
        assert warm["replicas"] == 2 and warm["pairs"] == 6
        assert check_journal(journal.path, strict=True) == []

    def test_submit_before_start_and_after_drain(self):
        registry = Registry()
        pool = ReplicaPool(build_engine_factory(registry), replicas=1,
                           registry=registry)
        with pytest.raises(ServeError, match="before start"):
            pool.submit("toy", images(1)[0])
        pool.start()
        ok, detail = pool.healthz()
        assert ok and detail["serving"] == 1
        pool.close()
        assert not pool.healthz()[0]
        with pytest.raises(ShedError) as ei:
            pool.submit("toy", images(1)[0])
        assert ei.value.reason == "draining"

    def test_shed_determinism_under_seeded_arrivals(self, journal):
        # a zero-refill budget: the Nth request sheds however the
        # scheduler interleaves
        pool = make_pool(journal=journal, replicas=2,
                         admission=AdmissionController(
                             max_queue_depth=64, rate_per_s=0.0, burst=4))
        outcomes, futs = [], []
        try:
            for im in images(10, seed=3):
                try:
                    futs.append(pool.submit("toy", im))
                    outcomes.append("admitted")
                except ShedError as e:
                    assert e.reason == "rate_limited"
                    outcomes.append("shed")
            for f in futs:
                f.result(timeout=30)
        finally:
            summary = pool.close()
        assert outcomes == ["admitted"] * 4 + ["shed"] * 6
        assert summary["shed"] == 6 and summary["accepted"] == 4
        assert summary["offered"] == 10
        journal.close()
        sheds = events(journal.path, "serve_shed")
        assert [e["reason"] for e in sheds] == ["rate_limited"] * 6
        assert check_journal(journal.path, strict=True) == []

    def test_queue_full_sheds_when_inflight_exceeds_bound(self, journal):
        # a long window parks the requests: the depth crosses the bound
        # with no completion racing it
        pool = make_pool(journal=journal, replicas=1, max_wait_ms=60_000,
                         admission=AdmissionController(max_queue_depth=2))
        try:
            futs = [pool.submit("toy", im) for im in images(2)]
            with pytest.raises(ShedError) as ei:
                pool.submit("toy", images(1)[0])
            assert ei.value.reason == "queue_full"
            assert pool.telemetry_status()["replicas"]["r0"]["inflight"] == 2
        finally:
            pool.close()
        assert all(f.done() for f in futs)

    def test_concurrent_submits_respect_the_queue_bound(self):
        # 8 clients through a barrier against a depth-2 bound with the
        # requests parked: the verdict and the in-flight increment are one
        # step, so exactly 2 admit
        pool = make_pool(replicas=1, max_wait_ms=60_000,
                         admission=AdmissionController(max_queue_depth=2))
        results = []
        res_lock = threading.Lock()
        barrier = threading.Barrier(8)

        def client(i):
            barrier.wait()
            try:
                fut = pool.submit("toy", images(1, seed=i)[0])
                with res_lock:
                    results.append(("ok", fut))
            except ShedError as e:
                with res_lock:
                    results.append(("shed", e.reason))

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        try:
            assert len([r for r in results if r[0] == "ok"]) == 2, results
            assert all(r[1] == "queue_full" for r in results
                       if r[0] == "shed")
        finally:
            pool.close()

    def test_slo_offered_vs_admitted_report(self):
        pool = make_pool(replicas=1,
                         admission=AdmissionController(
                             max_queue_depth=64, rate_per_s=0.0, burst=2))
        try:
            done = []
            for im in images(5):
                try:
                    done.append(pool.submit("toy", im))
                except ShedError:
                    pass
            for f in done:
                f.result(timeout=30)
            rep = pool.slo.report()["toy"]
            assert rep["offered"] == 5 and rep["shed"] == 3
            assert rep["admitted"] == 2
            assert rep["offered_rps"] >= rep["admitted_rps"] > 0
            assert "offered 5 shed 3" in pool.slo.render()
        finally:
            pool.close()

    def test_telemetry_is_not_ported(self):
        """(The name is kept from when `telemetry=` raised.) The pool
        registers the fleet view as `fleet`, and each replica's Server
        its own `serve:<rid>`."""
        tele = TelemetryServer()
        pool = ReplicaPool(build_engine_factory(Registry()), replicas=2,
                           telemetry=tele)
        assert list(tele.healthz()[1]["checks"]) == ["fleet"]
        pool.start()
        try:
            ok, body = tele.healthz()
            assert ok and sorted(body["checks"]) == [
                "fleet", "serve:r0", "serve:r1"]
            assert tele.statusz()["status"]["fleet"]["replicas"][
                "r1"]["state"] == "serving"
        finally:
            pool.close()


# -- replica death -----------------------------------------------------------

class TestReplicaDeath:
    def test_death_is_request_scoped_and_respawn_recovers(self, journal):
        pool = make_pool(journal=journal, replicas=2)
        w0 = warmup_count()
        try:
            faults.install_spec("serve.replica:io_error@1", seed=0,
                                journal=journal, export_env=False)
            futs = [pool.submit("toy", im) for im in images(6)]
            outcomes = []
            for f in futs:
                try:
                    f.result(timeout=30)
                    outcomes.append("ok")
                except ReplicaLost:
                    outcomes.append("lost")
            faults.install(None)
            # some requests died with the replica, the survivor served
            # the rest
            assert 1 <= outcomes.count("lost") < len(futs)
            assert wait_all_serving(pool), pool.replica_states()
            assert pool.submit(
                "toy", images(1)[0]).result(timeout=30) is not None
            assert warmup_count() == w0, \
                "a respawn reuses the surviving warmed engine"
        finally:
            summary = pool.close()
        assert summary["accepted"] == summary["completed"] \
            + summary["errors"] + summary["cancelled"]
        assert summary["errors"] == outcomes.count("lost")
        journal.close()
        lost = events(journal.path, "replica_lost")
        rec = events(journal.path, "replica_recovered")
        assert len(lost) == 1 and len(rec) == 1
        assert lost[0]["replica"] == rec[0]["replica"]
        assert lost[0]["attempt"] == 1 and rec[0]["attempt"] == 1
        errs = [e for e in events(journal.path, "serve_request")
                if e["outcome"] == "error"]
        assert {e["replica"] for e in errs} == {lost[0]["replica"]}
        assert all(e["error"].startswith("ReplicaLost") for e in errs)
        assert check_journal(journal.path, strict=True) == []

    def test_respawn_failure_retries_until_recovered(self, journal):
        # one replica, no concurrent traffic: hit 1 is the death batch,
        # hit 2 the first respawn attempt, which the policy retries. A
        # rule that fires ends the hit, so the second rule counts from
        # hit 2: each rule is "@1"
        pool = make_pool(journal=journal, replicas=1)
        try:
            faults.install_spec(
                "serve.replica:io_error@1;serve.replica:io_error@1",
                seed=0, journal=journal, export_env=False)
            fut = pool.submit("toy", images(1)[0])
            with pytest.raises(ReplicaLost):
                fut.result(timeout=30)
            assert wait_all_serving(pool), pool.replica_states()
            faults.install(None)
            assert pool.submit(
                "toy", images(1)[0]).result(timeout=30) is not None
        finally:
            faults.install(None)
            summary = pool.close()
        assert summary["accepted"] == 2 and summary["errors"] == 1
        assert summary["completed"] == 1
        journal.close()
        (rec,) = events(journal.path, "replica_recovered")
        assert rec["attempt"] == 2
        retries = [(e["name"], e["attempt"], e["outcome"])
                   for e in events(journal.path, "retry")]
        assert retries == [("serve.replica", 1, "retrying"),
                           ("serve.replica", 1, "recovered")]
        assert check_journal(journal.path, strict=True) == []

    def test_fresh_respawn_rewarms_the_engine(self, journal):
        pool = make_pool(journal=journal, replicas=1, respawn_fresh=True)
        w0 = warmup_count()
        try:
            faults.install_spec("serve.replica:io_error@1", seed=0,
                                journal=journal, export_env=False)
            with pytest.raises(ReplicaLost):
                pool.submit("toy", images(1)[0]).result(timeout=30)
            assert wait_all_serving(pool), pool.replica_states()
            faults.install(None)
            assert pool.submit(
                "toy", images(1)[0]).result(timeout=30) is not None
        finally:
            faults.install(None)
            pool.close()
        assert warmup_count() == w0 + 3  # the three buckets, no cache
        journal.close()
        (note,) = [e for e in events(journal.path, "note")
                   if e["note"] == "replica_respawn_fresh"]
        assert note["replica"] == "r0" and note["pairs"] == 3

    def test_fresh_respawn_through_a_cache_attaching_factory(
            self, journal, tmp_path):
        """A factory whose Engine attaches an executable cache (the same
        root every call: one cache a process). The fresh respawn builds
        a second engine through it, and the pool's warm-up note and the
        respawn's carry backend_compiles and cache_hits: 0 both, since
        in one process a library is compiled or loaded once."""
        from deep_vision_tpu_torch.core import build
        from deep_vision_tpu_torch.core.excache import ExecutableCache

        registry = Registry()
        engines = []

        def factory(rid):
            eng = Engine(device="cpu", registry=registry,
                         excache=ExecutableCache(str(tmp_path / "excache"),
                                                 journal=journal,
                                                 registry=registry))
            eng.register("toy", toy_fn, toy_variables(), input_shape=IMG,
                         buckets=(1, 2, 4))
            engines.append(eng)
            return eng

        try:
            pool = ReplicaPool(factory, replicas=1, journal=journal,
                               registry=registry, respawn_fresh=True,
                               max_wait_ms=3.0).start()
            try:
                faults.install_spec("serve.replica:io_error@1", seed=0,
                                    journal=journal, export_env=False)
                with pytest.raises(ReplicaLost):
                    pool.submit("toy", images(1)[0]).result(timeout=30)
                assert wait_all_serving(pool), pool.replica_states()
                faults.install(None)
                want = toy_fn(toy_variables(), torch.from_numpy(
                    np.stack(images(1))))["scores"]
                got = pool.submit("toy", images(1)[0]).result(timeout=30)
                assert torch.equal(torch.as_tensor(got["scores"]), want[0])
            finally:
                faults.install(None)
                pool.close()
        finally:
            build.detach_cache()
        assert len(engines) == 2
        assert engines[1].excache is engines[0].excache
        assert pool.warmup_stats["backend_compiles"] == 0
        journal.close()
        (note,) = [e for e in events(journal.path, "note")
                   if e["note"] == "replica_respawn_fresh"]
        assert note["pairs"] == 3
        assert (note["backend_compiles"], note["cache_hits"]) == (0, 0)
        assert check_journal(journal.path, strict=True) == []

    def test_all_replicas_down_is_a_clear_error(self, journal):
        pool = make_pool(
            journal=journal, replicas=1,
            respawn_policy=RetryPolicy(
                name="serve.replica", max_attempts=1, base_delay_s=0.01,
                journal=journal, retry_on=(OSError, TimeoutError)))
        try:
            # every hit fires: the death and the single respawn attempt
            faults.install_spec("serve.replica:io_error@0.999999", seed=1,
                                journal=journal, export_env=False)
            fut = pool.submit("toy", images(1)[0])
            with pytest.raises(ServeError):
                fut.result(timeout=30)
            deadline = time.time() + 10
            while time.time() < deadline and \
                    pool.replica_states()["r0"] != "dead":
                time.sleep(0.02)
            time.sleep(0.1)  # let the give-up retire the dead server
            faults.install(None)
            assert pool.replica_states()["r0"] == "dead"
            assert not pool.healthz()[0]
            with pytest.raises(ServeError, match="no serving replica"):
                pool.submit("toy", images(1)[0])
        finally:
            faults.install(None)
            summary = pool.close()
        # the dead replica's ledger folds in once, and the unroutable
        # request is refused, not admitted
        assert summary["accepted"] == 1 and summary["errors"] == 1
        assert summary["refused"] == 1
        assert summary["offered"] == summary["accepted"] \
            + summary["shed"] + summary["refused"]
        journal.close()
        assert [e["note"] for e in events(journal.path, "note")
                if e["note"].startswith("replica_")] == \
            ["replica_respawn_gave_up"]
        assert [e["outcome"] for e in events(journal.path, "retry")] == \
            ["gave_up"]


# -- locksmith-armed pool ----------------------------------------------------

def test_armed_lifecycle_zero_violations(journal):
    # the sanitizer across submit, route, death, respawn and drain: the
    # pool lock never inverts against the servers' or the queues' locks
    locksmith.arm(journal=journal)
    try:
        pool = make_pool(journal=journal, replicas=2,
                         admission=AdmissionController(max_queue_depth=64))
        faults.install_spec("serve.replica:io_error@2", seed=0,
                            journal=journal, export_env=False)
        for f in [pool.submit("toy", im) for im in images(12)]:
            try:
                f.result(timeout=30)
            except ServeError:
                pass
        faults.install(None)
        assert wait_all_serving(pool)
        pool.close()
        report = locksmith.report()
        assert report["violations"] == [], report["violations"]
        assert "serve.pool" in report["locks"]
    finally:
        faults.install(None)
        locksmith.disarm()
    journal.close()
    assert not events(journal.path, "lock_order_violation")


# -- journal schema ----------------------------------------------------------

def _bad_rows():
    return [
        {"event": "serve_shed", "ts": 1.0, "run_id": "r", "model": "toy",
         "reason": "mood"},
        {"event": "serve_swap", "ts": 1.0, "run_id": "r", "phase": "yolo",
         "outcome": "ok"},
        {"event": "serve_swap", "ts": 1.0, "run_id": "r", "phase": "warm",
         "outcome": "perhaps"},
        {"event": "replica_lost", "ts": 1.0, "run_id": "r", "replica": 3,
         "attempt": "one"},
        {"event": "replica_recovered", "ts": 1.0, "run_id": "r",
         "replica": "r0"},
        {"event": "exit", "ts": 2.0, "run_id": "r", "status": "clean"},
    ]


def test_strict_rejects_the_same_bad_fleet_enums(tmp_path):
    # the bad rows written through the port's journal and raw (as the
    # reference's test writes them) draw the same complaints
    from deep_vision_tpu.obs import RunJournal as RefJournal

    port = RunJournal(str(tmp_path / "port.jsonl"), run_id="r",
                      kind="serve")
    ref = RefJournal(str(tmp_path / "ref.jsonl"), run_id="r", kind="serve")
    for j in (port, ref):
        for row in _bad_rows()[:-1]:
            fields = {k: v for k, v in row.items()
                      if k not in ("event", "ts", "run_id")}
            j.write(row["event"], **fields)
        j.close()
    raw = str(tmp_path / "raw.jsonl")
    with open(raw, "w") as f:
        for r in _bad_rows():
            f.write(json.dumps(r) + "\n")

    def complaints(path):
        return sorted(e.split(": ", 1)[1].split(" (")[0]
                      for e in check_journal(path, strict=True)
                      if "serve_" in e or "replica_" in e)

    got = complaints(port.path)
    assert got == complaints(ref.path)
    assert got == complaints(raw)
    for what in ("serve_shed reason", "serve_swap phase",
                 "serve_swap outcome", "replica_lost replica",
                 "replica_lost attempt",
                 "replica_recovered event missing field 'attempt'"):
        assert any(what in e for e in got), (what, got)


# -- the respawn's retry policy ----------------------------------------------

@pytest.mark.parametrize("deadline_s", [None, 2.5])
def test_retry_events_and_deadline_match_the_reference(tmp_path, deadline_s):
    # the same failing call (two OSErrors, then a result) through both
    # packages' RetryPolicy on one fake clock: the same typed `retry` rows
    # (recovered without a deadline; gave_up where the next delay would
    # cross it), the same result or error
    from deep_vision_tpu.obs import RunJournal as RefJournal
    from deep_vision_tpu.obs import read_journal as ref_read_journal
    from deep_vision_tpu.resilience import RetryPolicy as RefRetryPolicy

    def run(cls, journal):
        t = {"now": 0.0}
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise OSError(f"transient {calls['n']}")
            return "ok"

        policy = cls(name="serve.replica", max_attempts=4, base_delay_s=1.0,
                     jitter=0.0, deadline_s=deadline_s, journal=journal,
                     registry=Registry() if cls is RetryPolicy else None,
                     sleep=lambda d: t.update(now=t["now"] + d),
                     clock=lambda: t["now"])
        try:
            out = policy.call(flaky)
        except OSError as e:
            out = f"raised {e}"
        journal.close()
        return out

    port = RunJournal(str(tmp_path / "port.jsonl"), kind="serve")
    ref = RefJournal(str(tmp_path / "ref.jsonl"), kind="serve")
    got, want = run(RetryPolicy, port), run(RefRetryPolicy, ref)
    assert got == want == ("ok" if deadline_s is None
                           else "raised transient 2")

    def rows(read, path):
        return [{k: r[k] for k in ("name", "attempt", "error", "outcome",
                                   "delay_s")}
                for r in read(path) if r["event"] == "retry"]

    assert rows(read_journal, port.path) == rows(ref_read_journal, ref.path)
    assert [r["outcome"] for r in rows(read_journal, port.path)] == (
        ["retrying", "retrying", "recovered"] if deadline_s is None
        else ["retrying", "gave_up"])
    assert check_journal(port.path, strict=True) == []


def test_racing_clients_keep_the_ledgers_balanced():
    # more client threads than cores and a 1 us switch interval: a lost
    # update to the in-flight counts or the request ledgers would leave
    # an in-flight request behind or unbalance the drain
    import sys as _sys

    pool = make_pool(replicas=2, max_wait_ms=1.0,
                     admission=AdmissionController(max_queue_depth=24))
    futs, sheds = [], []
    lock = threading.Lock()

    def client(i):
        for im in images(8, seed=100 + i):
            try:
                fut = pool.submit("toy", im)
                with lock:
                    futs.append(fut)
            except ShedError as e:
                with lock:
                    sheds.append(e.reason)

    interval = _sys.getswitchinterval()
    _sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for f in futs:
            f.result(timeout=60)
    finally:
        _sys.setswitchinterval(interval)
        summary = pool.close()
    assert len(futs) + len(sheds) == 16 * 8
    assert set(sheds) <= {"queue_full"}
    assert summary["accepted"] == summary["completed"] == len(futs)
    assert summary["offered"] == summary["accepted"] + summary["shed"]
    assert all(r["inflight"] == 0
               for r in pool.telemetry_status()["replicas"].values())
