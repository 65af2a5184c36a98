"""The port's process fleet (serve/procpool.py) on the CPU, against the
JAX package's: replicas are spawned processes over real sockets.

One port fleet and one reference fleet serve the whole module, each
`ProcReplicaPool(fleet_builder, replicas=2)` without an executable
cache (every child on one torch thread: OMP_NUM_THREADS=1); a pool
over `excache_dir=` runs in a subprocess of its own, a fresh parent. On
the same seeded images the two fleets answer the same `toy` and `aux`
rows. Then on the port's fleet, in order: a Transport fronts it and one trace
crosses both sockets (tests/test_transport.py:568-614); a canary swap is
promoted across processes and every base replica then answers with the
new weights; a poisoned canary (NaN weights: its abort health policy
turns them into request errors) rolls back and the promoted weights go
on answering; a SIGKILL costs only the dead replica's in-flight
requests, typed `ReplicaLost`, and the replica comes back as attempt 2
having built no kernel (tests/test_transport.py:496-566, without the
cache's asserts); the drain balances the parent's and every child's
ledger, and the journals pass `tools/check_journal.py --strict` (the
SIGKILLed child's lacks only its terminal event).
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deep_vision_tpu.obs import RunJournal as RefJournal
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu.serve import ProcReplicaPool as RefProcReplicaPool
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.obs import propagate
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.serve import (
    DEADLINE_HEADER,
    ProcReplicaPool,
    ReplicaLost,
    SwapController,
    Transport,
    swap_tree,
)
from deep_vision_tpu_torch.serve.swap import compile_count
from deep_vision_tpu_torch.tools.loadgen import (
    IMG,
    HttpLoadClient,
    fleet_builder,
    toy_fn,
    toy_variables,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.check_journal import check_journal  # noqa: E402
from tools.loadgen import fleet_builder as ref_fleet_builder  # noqa: E402

PORT_KW = {"device": "cpu"}
SEEDED = [np.random.RandomState(s).rand(*IMG).astype(np.float32)
          for s in range(6)]


def events(path, name):
    return [e for e in read_journal(path) if e.get("event") == name]


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


class Fleet:
    def __init__(self, pool, journal, work):
        self.pool = pool
        self.journal = journal
        self.work = work


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The port's fleet and the reference's, started together; every
    child, respawns and canaries included, on one torch thread."""
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    out = {}
    for name, cls, builder, journal_cls, registry, kw in (
            ("port", ProcReplicaPool, fleet_builder, RunJournal, Registry,
             {"builder_kwargs": PORT_KW}),
            ("ref", RefProcReplicaPool, ref_fleet_builder, RefJournal,
             RefRegistry, {})):
        work = str(tmp_path_factory.mktemp(name))
        journal = journal_cls(os.path.join(work, "journal.jsonl"),
                              kind="serve")
        journal.manifest()
        pool = cls(builder, replicas=2, run_dir=work, journal=journal,
                   registry=registry(), heartbeat_s=0.4,
                   ready_timeout_s=120.0, **kw)
        out[name] = Fleet(pool, journal, work)
    starts = [threading.Thread(target=f.pool.start) for f in out.values()]
    for t in starts:
        t.start()
    for t in starts:
        t.join(180)
    yield out
    for f in out.values():
        f.pool.drain("close")
        f.journal.close()
    if threads is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = threads


@pytest.fixture(scope="module")
def port(fleets):
    return fleets["port"]


def test_excache_dir_loads_each_process_through_the_cache(tmp_path):
    """`excache_dir=` is taken: in a fresh parent over an empty cache the
    template's builder loads the record library (fleet_builder's
    native=True) and compiles it into the cache; the child, a fresh
    process, compiles nothing and reports the library as its cache hit;
    the journals carry the excache rows and pass --strict."""
    run, cache = str(tmp_path / "run"), str(tmp_path / "excache")
    script = (
        "import json, os\n"
        "import numpy as np\n"
        "from deep_vision_tpu_torch.obs.journal import RunJournal\n"
        "from deep_vision_tpu_torch.serve import ProcReplicaPool\n"
        "from deep_vision_tpu_torch.tools.loadgen import IMG, fleet_builder\n"
        "if __name__ == '__main__':\n"
        f"    os.makedirs({run!r})\n"
        f"    journal = RunJournal(os.path.join({run!r}, 'journal.jsonl'),"
        " kind='serve')\n"
        "    journal.manifest()\n"
        "    pool = ProcReplicaPool(fleet_builder, replicas=1,"
        f" run_dir={run!r}, excache_dir={cache!r}, journal=journal,"
        " heartbeat_s=0.4,"
        " builder_kwargs={'device': 'cpu', 'native': True}).start()\n"
        "    row = pool.submit('toy', np.zeros(IMG, np.float32)).result(60)\n"
        "    print(json.dumps({'template': pool.template_warmup,"
        " 'children': pool.warmup_stats(), 'row': sorted(row)}))\n"
        "    pool.drain('close')\n"
        "    journal.close()\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert got["row"] == ["mean", "scores"]
    assert (got["template"]["backend_compiles"],
            got["template"]["cache_hits"]) == (1, 0)
    assert (got["children"]["p0"]["backend_compiles"],
            got["children"]["p0"]["cache_hits"]) == (0, 1)
    rows = {}
    for name in ("journal.jsonl", "replica-p0-a1.jsonl"):
        path = os.path.join(run, name)
        assert check_journal(path, strict=True) == []
        rows[name] = [(e["event"], e["name"]) for e in read_journal(path)
                      if e["event"].startswith("excache_")]
    assert rows == {
        "journal.jsonl": [("excache_miss", "dvtpu_records"),
                          ("excache_store", "dvtpu_records")],
        "replica-p0-a1.jsonl": [("excache_hit", "dvtpu_records")]}


def test_an_undrained_pool_stops_its_children_at_exit(tmp_path):
    """A parent that exits without draining (a failed check, an
    exception) neither hangs nor leaves a child behind: the pool drains
    at exit before multiprocessing terminates its children, which its
    monitor would otherwise respawn."""
    script = (
        "import sys\n"
        "from deep_vision_tpu_torch.serve import ProcReplicaPool\n"
        "from deep_vision_tpu_torch.tools.loadgen import fleet_builder\n"
        "if __name__ == '__main__':\n"
        f"    pool = ProcReplicaPool(fleet_builder, run_dir={str(tmp_path)!r},"
        " builder_kwargs={'device': 'cpu'}, heartbeat_s=0.4).start()\n"
        "    print(*[s.proc.pid for s in pool._slots.values()], flush=True)\n"
        "    sys.exit(3)\n")
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 3, res.stderr[-2000:]
    assert time.monotonic() - t0 < 60
    for pid in map(int, res.stdout.split()):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert not any(p.startswith("replica-") and "-a2" in p
                   for p in os.listdir(tmp_path))


def test_rows_equal_the_reference_fleets(fleets):
    got = {}
    for name, f in fleets.items():
        futs = [f.pool.submit("toy" if i % 2 else "aux", img)
                for i, img in enumerate(SEEDED)]
        got[name] = [fut.result(timeout=60) for fut in futs]
    for i, (port_row, ref_row) in enumerate(zip(got["port"], got["ref"])):
        assert sorted(port_row) == sorted(ref_row)
        for k in port_row:
            want = np.asarray(ref_row[k], np.float32)
            err = np.abs(np.asarray(port_row[k], np.float32) - want).max()
            assert err <= 1e-5 * max(np.abs(want).max(), 1e-6), (i, k, err)
    port_w = fleets["port"].pool.warmup_stats()
    ref_w = fleets["ref"].pool.warmup_stats()
    assert sorted(port_w) == sorted(ref_w) == ["p0", "p1"]
    for rid in port_w:
        assert sorted(port_w[rid]) == sorted(ref_w[rid])
        assert (port_w[rid]["models"], port_w[rid]["pairs"]) == \
            (ref_w[rid]["models"], ref_w[rid]["pairs"]) == (2, 6)
        assert port_w[rid]["backend_compiles"] == 0
        assert port_w[rid]["cache_hits"] == 0
    for name, f in fleets.items():
        assert f.pool.ledger()["balanced"], name
        assert f.pool.replica_states() == {"p0": "serving", "p1": "serving"}


def test_transport_fronts_the_process_fleet(port):
    tp = Transport(port.pool, journal=port.journal,
                   registry=port.pool.registry).start()
    ctx = propagate.new_trace()
    client = HttpLoadClient("127.0.0.1", tp.port, deadline_ms=30000.0)
    try:
        with propagate.use(ctx):
            row = client.submit("toy", SEEDED[0]).result(timeout=60)
        st, health = get(tp.port, "/healthz")
        st2, statusz = get(tp.port, "/statusz")
    finally:
        client.close()
        tp.close()
    assert set(row) == {"scores", "mean"}
    assert st == 200 and health["ok"] is True
    assert st2 == 200
    assert statusz["telemetry_status"]["replicas"] == {
        "p0": "serving", "p1": "serving"}
    assert tp.ledger()["ok"] == 1 and tp.ledger()["balanced"]
    # the trace crossed both sockets: the parent's transport row and
    # exactly one child's share the trace id
    parent = [e for e in events(port.journal.path, "transport_request")
              if e.get("trace_id") == ctx.trace_id]
    assert len(parent) == 1 and parent[0]["status"] == 200
    hops = []
    for p in sorted(os.listdir(port.work)):
        if p.startswith("replica-") and p.endswith(".jsonl"):
            hops += [e for e in events(os.path.join(port.work, p),
                                       "transport_request")
                     if e.get("trace_id") == ctx.trace_id]
    assert len(hops) == 1 and hops[0]["status"] == 200


class Traffic:
    """Closed-loop toy requests from a thread while a swap runs."""

    def __init__(self, pool):
        self.pool = pool
        self.stop = threading.Event()
        self.failures = []
        self.ok = 0
        self.thread = threading.Thread(target=self.run, daemon=True)

    def run(self):
        rng = np.random.RandomState(3)
        while not self.stop.is_set():
            try:
                self.pool.submit("toy", rng.rand(*IMG).astype(
                    np.float32)).result(timeout=60)
                self.ok += 1
            except Exception as e:
                self.failures.append(f"{type(e).__name__}: {e}")
            time.sleep(0.002)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(60)


def swap_with_traffic(pool, journal, ckpt, step):
    swapper = SwapController(pool, journal=journal, canary_pct=50,
                             min_canary_requests=4, canary_timeout_s=60.0)
    c0 = compile_count()
    with Traffic(pool) as traffic:
        verdict = swapper.swap(ckpt, step=step, models=("toy",))
    return verdict, compile_count() - c0, traffic


def answers(pool, n=4):
    """n toy answers to SEEDED[0] (round-robin: each base replica's)."""
    futs = [pool.submit("toy", SEEDED[0]) for _ in range(n)]
    return [np.asarray(f.result(timeout=60)["scores"], np.float32)
            for f in futs]


def scores(variables):
    x = torch.from_numpy(SEEDED[0][None])
    return toy_fn(variables, x)["scores"][0].numpy()


@pytest.fixture(scope="module")
def ckpt(port):
    mgr = CheckpointManager(os.path.join(port.work, "swap"),
                            journal=port.journal)
    new = toy_variables(scale=2.0, seed=7)
    mgr.save_tree(1, swap_tree({"toy": new}))
    poisoned = {"w": new["w"].clone()}
    poisoned["w"][0, :] = float("nan")
    mgr.save_tree(2, swap_tree({"toy": poisoned}))
    mgr.wait()
    yield mgr, new
    mgr.close()


def test_promoted_swap_crosses_processes(port, ckpt):
    mgr, new = ckpt
    verdict, delta, traffic = swap_with_traffic(port.pool, port.journal,
                                                mgr, 1)
    assert verdict["outcome"] == "promoted", verdict
    assert delta == 0 and not traffic.failures, traffic.failures
    assert [(t["phase"], t["outcome"]) for t in verdict["timeline"]] == [
        ("warm", "started"), ("warm", "ok"), ("canary", "started"),
        ("canary", "ok"), ("promote", "ok")]
    want = scores(new)
    for got in answers(port.pool):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        port.pool.primary_engine().entry("toy").variables["w"].numpy(),
        new["w"].numpy())
    assert port.pool.replica_states() == {"p0": "serving", "p1": "serving"}
    canary = events(os.path.join(port.work, "replica-canary1-a1.jsonl"),
                    "serve_request")
    assert len(canary) >= 4


def test_poisoned_swap_rolls_back_across_processes(port, ckpt):
    mgr, new = ckpt
    verdict, delta, traffic = swap_with_traffic(port.pool, port.journal,
                                                mgr, 2)
    assert verdict["outcome"] == "rolled_back", verdict
    assert verdict["reason"] == "errors" and delta == 0
    # the diverted requests failed on the canary, none elsewhere
    canary = verdict["timeline"][2]["replica"]
    assert traffic.failures and all(
        f"{canary} answered 500" in f and "non-finite" in f
        for f in traffic.failures)
    want = scores(port.pool.primary_engine().entry("toy").variables)
    for got in answers(port.pool):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert port.pool.canary_status() is None
    assert port.pool.replica_states() == {"p0": "serving", "p1": "serving"}


def test_sigkill_costs_only_the_dead_replicas_requests(port):
    pool = port.pool
    victim = pool._slots["p0"]
    futs = [pool.submit("toy", SEEDED[1]) for _ in range(8)]
    os.kill(victim.proc.pid, signal.SIGKILL)
    outcomes = {"ok": 0, "lost": 0}
    for fut in futs:
        try:
            fut.result(timeout=60)
            outcomes["ok"] += 1
        except ReplicaLost:
            outcomes["lost"] += 1
    assert outcomes["ok"] >= 1
    assert outcomes["ok"] + outcomes["lost"] == 8
    deadline = time.time() + 60
    while time.time() < deadline and not (
            pool.replica_states()["p0"] == "serving"
            and victim.attempt == 2):
        time.sleep(0.05)
    assert victim.attempt == 2
    assert pool.replica_states()["p0"] == "serving"
    assert pool.warmup_stats()["p0"]["backend_compiles"] == 0
    assert pool.submit("toy", SEEDED[1]).result(timeout=60) is not None
    lost = events(port.journal.path, "replica_lost")
    rec = events(port.journal.path, "replica_recovered")
    assert [(e["replica"], e["attempt"]) for e in lost] == [("p0", 1)]
    assert [(e["replica"], e["attempt"]) for e in rec] == [("p0", 2)]
    assert rec[0]["backend_compiles"] == 0 and rec[0]["pairs"] == 6
    # the rebirth serves the template's weights (after a promote, the
    # promote's file)
    want = scores(pool.primary_engine().entry("toy").variables)
    for got in answers(pool):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_deadline_rides_the_proxied_hop(port):
    fut = port.pool.submit("toy", SEEDED[2], deadline_ms=20000.0)
    assert fut.result(timeout=60) is not None
    rows = []
    for p in sorted(os.listdir(port.work)):
        if p.startswith("replica-p") and p.endswith(".jsonl"):
            rows += [e for e in events(os.path.join(port.work, p),
                                       "transport_request")
                     if 0 < e["deadline_ms"] <= 20000.0]
    assert len(rows) == 1 and rows[0]["outcome"] == "ok"
    assert DEADLINE_HEADER == "X-DVT-Deadline-Ms"


def test_drain_balances_and_journals_pass_strict(port):
    pool = port.pool
    children = pool.child_ledgers()
    assert sorted(children) == ["p0", "p1"]
    for rid, led in children.items():
        assert led["balanced"], (rid, led)
    summary = pool.drain("close")
    assert summary["outcome"] == "flushed" and summary["pending"] == 0
    assert summary["accepted"] == (summary["completed"] + summary["errors"]
                                   + summary["cancelled"])
    assert pool.replica_states() == {"p0": "dead", "p1": "dead"}
    assert all(not s.proc.is_alive() for s in pool._slots.values())
    port.journal.close()
    journals = sorted(p for p in os.listdir(port.work)
                      if p.endswith(".jsonl"))
    killed = {f"replica-{e['replica']}-a{e['attempt']}.jsonl"
              for e in events(port.journal.path, "replica_lost")}
    assert {"journal.jsonl", "replica-p0-a1.jsonl",
            "replica-p1-a1.jsonl"} <= set(journals)
    assert killed <= set(journals)
    for name in journals:
        path = os.path.join(port.work, name)
        errs = check_journal(path, strict=True)
        if name in killed:  # SIGKILLed: no terminal row
            assert len(errs) == 1 and "no terminal event" in errs[0]
            continue
        assert errs == [], errs
        if name.startswith("replica-"):
            drain, = events(path, "serve_drain")
            assert drain["accepted"] == (drain["completed"]
                                         + drain["errors"]
                                         + drain["cancelled"])
            assert drain["pending"] == 0
