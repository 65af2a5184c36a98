"""The port's Server under its black box (serve/router.py with
obs/journal, trace, flight, locksmith) against the JAX package's Server.

The reference Server runs tests/test_serve.py's toy predictor in JAX,
the port's Server the same function in torch on the same weights; fed
the same requests in the same bursts (a burst of 4 fills bucket 4
before its window closes, a burst of 3 waits out the window into bucket
4, a lone request takes bucket 1, and a NaN image poisons its batch),
they journal the same `serve_request`, `serve_batch`, `serve_drain` and
`health` rows, times and trace ids masked. Also: a `data.read` fault
fails one request, `health_policy="abort"` fails a NaN batch, a SIGTERM
drain leaves one valid `preempt` bundle and a clean close none, an
armed drain journals zero lock violations, each batch is one
`serve/batch` span, `telemetry=` raises, and `check_journal --strict`
accepts the port's journal.
"""
import os
import signal
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.obs import RunJournal as RefJournal
from deep_vision_tpu.obs import read_journal as ref_read_journal
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu.resilience import faults as ref_faults
from deep_vision_tpu.serve import Engine as RefEngine
from deep_vision_tpu.serve import Server as RefServer
from deep_vision_tpu_torch.obs import flight, locksmith, propagate, trace
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.resilience import FaultInjected, faults
from deep_vision_tpu_torch.serve import Engine, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

IMG = (4, 4, 1)
BURSTS = (4, 3, 1)
#: a window long enough that a burst's requests always share it
WINDOW_MS = 300.0


def toy_fn(variables, images):
    flat = images.reshape(images.shape[0], -1)
    return {"scores": flat @ variables["w"],
            "mean": images.mean(dim=(1, 2, 3))}


def ref_toy_fn(variables, images):
    flat = images.reshape((images.shape[0], -1))
    return {"scores": flat @ variables["w"],
            "mean": images.mean(axis=(1, 2, 3))}


def weights(seed=0):
    return np.random.RandomState(seed).randn(16, 3).astype(np.float32)


def images(n, seed=1, nan_at=None):
    rng = np.random.RandomState(seed)
    out = [rng.rand(*IMG).astype(np.float32) for _ in range(n)]
    if nan_at is not None:
        out[nan_at][0, 0, 0] = np.nan
    return out


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.install(None)
    ref_faults.install(None)
    for mod in (faults, ref_faults):
        os.environ.pop(mod.ENV_SPEC, None)
        os.environ.pop(mod.ENV_SEED, None)
    flight.set_flight(None)
    trace.set_tracer(None)
    locksmith.disarm()


def port_server(journal, **kw):
    eng = Engine(device="cpu", registry=Registry())
    eng.register("toy", toy_fn, {"w": torch.from_numpy(weights())},
                 input_shape=IMG, buckets=(1, 2, 4))
    eng.warmup()
    kw.setdefault("max_wait_ms", WINDOW_MS)
    return Server(eng, journal=journal, registry=Registry(),
                  tags={"replica": "r0"}, **kw).start()


def ref_server(journal, **kw):
    eng = RefEngine(registry=RefRegistry())
    eng.register("toy", ref_toy_fn, {"w": jnp.asarray(weights())},
                 input_shape=IMG, buckets=(1, 2, 4))
    eng.warmup()
    kw.setdefault("max_wait_ms", WINDOW_MS)
    return RefServer(eng, journal=journal, registry=RefRegistry(),
                     tags={"replica": "r0"}, **kw).start()


def drive(srv):
    """The bursts, each waited for; the last holds a NaN image."""
    results = []
    for i, n in enumerate(BURSTS):
        futs = [srv.submit("toy", im) for im in images(
            n, seed=10 + i, nan_at=0 if i == len(BURSTS) - 1 else None)]
        for f in futs:
            try:
                results.append(f.result(timeout=60))
            except Exception as e:  # either package's ServeError
                results.append(type(e).__name__)
    return results, srv.close()


MASK = ("ts", "run_id", "latency_ms", "queue_wait_ms", "exec_ms",
        "trace_id", "span_id", "parent_span_id")


def serve_rows(rows):
    out = []
    for r in rows:
        if r["event"] not in ("serve_request", "serve_batch", "serve_drain",
                              "health"):
            continue
        if r["event"] == "serve_request":
            assert propagate.valid_trace_id(r["trace_id"])
            assert propagate.valid_span_id(r["span_id"])
        out.append({k: v for k, v in r.items() if k not in MASK})
    return out


@pytest.mark.parametrize("policy", ["warn", "abort"])
def test_same_requests_same_rows(tmp_path, policy):
    pj = RunJournal(str(tmp_path / "port.jsonl"), kind="serve")
    rj = RefJournal(str(tmp_path / "ref.jsonl"), kind="serve")
    got, got_drain = drive(port_server(pj, health_policy=policy))
    want, want_drain = drive(ref_server(rj, health_policy=policy))
    pj.close()
    rj.close()
    port_rows = serve_rows(read_journal(pj.path))
    assert port_rows == serve_rows(ref_read_journal(rj.path))
    assert got_drain == want_drain
    assert [type(r) is dict for r in got] == [type(r) is dict for r in want]
    for g, w in zip(got, want):
        if isinstance(g, dict):
            for k in g:
                np.testing.assert_allclose(g[k], np.asarray(w[k]),
                                           rtol=1e-6, atol=1e-6)
    batches = [(r["bucket"], r["size"]) for r in port_rows
               if r["event"] == "serve_batch"]
    assert batches == [(4, 4), (4, 3), (1, 1)]
    (health,) = [r for r in port_rows if r["event"] == "health"]
    assert health == {"event": "health", "kind": "non_finite",
                      "policy": policy, "monitor": "serve",
                      "fields": ["mean", "scores"], "action": policy,
                      "model": "toy", "batch_size": 1, "replica": "r0"}
    outcomes = [r["outcome"] for r in port_rows
                if r["event"] == "serve_request"]
    assert outcomes == ["ok"] * 7 + ["error" if policy == "abort" else "ok"]
    from tools.check_journal import check_journal

    assert check_journal(pj.path, strict=True) == []


def test_fault_fails_one_request_and_the_trace_has_each_batch(tmp_path):
    journal = RunJournal(str(tmp_path / "s.jsonl"), kind="serve")
    tracer = trace.Tracer(str(tmp_path / "s.trace.json"))
    trace.set_tracer(tracer)
    srv = port_server(journal, max_wait_ms=1.0)
    try:
        faults.install_spec("data.read:io_error@2", seed=3, journal=journal,
                            export_env=False)
        futs = [srv.submit("toy", im) for im in images(3)]
        with pytest.raises(FaultInjected):
            futs[1].result(timeout=30)
        for f in (futs[0], futs[2]):
            assert f.result(timeout=30)["scores"].shape == (3,)
        faults.install(None)
        assert srv.submit("toy", images(1)[0]).result(timeout=30)
        ctx = propagate.new_trace()
        with propagate.use(ctx):
            srv.submit("toy", images(1)[0]).result(timeout=30)
    finally:
        srv.close()
        trace.set_tracer(None)
        tracer.close()
    journal.close()
    rows = read_journal(journal.path)
    assert any(r["event"] == "fault" and r["point"] == "data.read"
               for r in rows)
    reqs = [r for r in rows if r["event"] == "serve_request"]
    assert [r["outcome"] for r in reqs].count("error") == 1
    assert "FaultInjected" in next(r["error"] for r in reqs
                                   if r["outcome"] == "error")
    assert len({r["trace_id"] for r in reqs}) == len(reqs)
    # a traced client makes the request its child
    assert reqs[-1]["trace_id"] == ctx.trace_id
    assert reqs[-1]["parent_span_id"] == ctx.span_id
    import json

    doc = json.load(open(tracer.path))
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    n_batches = sum(r["event"] == "serve_batch" for r in rows)
    assert names.count("serve/batch") == n_batches > 0
    assert names.count("serve/drain") == 1
    from tools.check_journal import check_journal, check_trace

    assert check_journal(journal.path, strict=True) == []
    assert check_trace(tracer.path) == []


def test_sigterm_drain_leaves_one_bundle_clean_close_none(tmp_path):
    journal = RunJournal(str(tmp_path / "s.jsonl"), kind="serve")
    fdir = str(tmp_path / "flight")
    fr = flight.FlightRecorder(fdir, run_id=journal.run_id)
    fr.attach(journal)
    flight.set_flight(fr)
    clean = port_server(journal)
    clean.submit("toy", images(1)[0]).result(timeout=30)
    assert "flight_bundle" not in clean.close()
    assert flight.find_bundles(fdir) == []
    srv = port_server(journal, max_wait_ms=60_000)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        srv.install_sigterm()
        futs = [srv.submit("toy", im) for im in images(2)]
        os.kill(os.getpid(), signal.SIGTERM)
        assert srv.wait_for_stop(timeout=10)
        summary = srv.drain("sigterm")
        assert summary["outcome"] == "flushed"
        assert all(f.result(timeout=30) is not None for f in futs)
        bundles = flight.find_bundles(fdir)
        assert bundles == [summary["flight_bundle"]]
        assert "preempt" in bundles[0]
        assert flight.validate_bundle(bundles[0]) == []
    finally:
        srv.uninstall_sigterm()
        signal.signal(signal.SIGTERM, prev)
        fr.close()
    journal.close()
    rows = read_journal(journal.path)
    drains = [r for r in rows if r["event"] == "serve_drain"]
    assert [d["reason"] for d in drains] == ["close", "sigterm"]
    assert any(r["event"] == "flight_dump" and r["reason"] == "preempt"
               and r["outcome"] == "written" for r in rows)
    from tools.check_journal import check_journal

    assert check_journal(journal.path, strict=True) == []


def test_armed_drain_zero_violations(tmp_path):
    """A Server's life under the armed sanitizer (warmup, submits from
    several threads, drain), as the reference's
    test_concurlint.test_clean_serve_drain_zero_violations."""
    import threading

    journal = RunJournal(str(tmp_path / "s.jsonl"), kind="serve")
    journal.manifest(config={"name": "locksmith_serve", "task": "serving"})
    san = locksmith.arm(journal=journal, registry=Registry())
    srv = port_server(journal, max_wait_ms=2.0)
    errs = []

    def client(seed):
        try:
            for im in images(6, seed=seed):
                srv.submit("toy", im).result(timeout=30)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    summary = srv.close()
    rep = san.report()
    locksmith.disarm()
    journal.close()
    assert errs == [] and summary["completed"] == 24
    assert rep["violations"] == []
    assert {"serve.device", "serve.counts", "serve.submit", "serve.queue",
            "obs.journal"} <= set(rep["locks"])
    rows = read_journal(journal.path)
    assert not any(r["event"] == "lock_order_violation" for r in rows)


def test_constructor_takes_the_references_order():
    eng = Engine(device="cpu", registry=Registry())
    eng.register("toy", toy_fn, {"w": torch.from_numpy(weights())},
                 input_shape=IMG, buckets=(1,))
    eng.warmup()
    import inspect

    got = list(inspect.signature(Server).parameters)
    want = list(inspect.signature(RefServer).parameters)
    assert got == want
    with pytest.raises(NotImplementedError, match="telemetry"):
        Server(eng, telemetry=object())
    with pytest.raises(ValueError, match="health_policy"):
        Server(eng, health_policy="skip_step")
