"""The port's front door (serve/transport.py) and socket client
(tools/loadgen.py `HttpLoadClient`) against the JAX package's, on
tests/test_transport.py's scenarios before TestProcessFleet: the status
mapping of every shed reason (429/503 with Retry-After), deadlines shed
at admission and at dispatch (504), bad requests (400/404), the W3C
traceparent through the socket, torn and corrupt frames at the
`serve.transport` fault point, the control verbs, the pages, and the
retrying client honouring Retry-After.

Each scenario runs once against each package's Transport, over
backends that behave alike (an in-memory backend, or each package's
Server on the same toy model), and returns what a client and the
journal saw: status codes, Retry-After values, bodies (latencies and
trace ids masked), the ledger, and the journal rows' fields. The two
must be equal.
"""
import http.client
import json
import os
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deep_vision_tpu.obs as ref_obs
import deep_vision_tpu.serve as ref_serve
from deep_vision_tpu.core import knobs as ref_knobs
from deep_vision_tpu.obs import propagate as ref_propagate
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu.resilience import RetryPolicy as RefRetryPolicy
from deep_vision_tpu.resilience import faults as ref_faults
from deep_vision_tpu_torch import serve as port_serve
from deep_vision_tpu_torch.core import knobs
from deep_vision_tpu_torch.obs import propagate
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.resilience import RetryPolicy, faults
from deep_vision_tpu_torch.serve.transport import _jsonable_outputs
from deep_vision_tpu_torch.tools import loadgen as port_loadgen
from tools import loadgen as ref_loadgen

IMG = (4, 4, 1)

REF = SimpleNamespace(
    name="ref", serve=ref_serve, journal=ref_obs.RunJournal,
    read_journal=ref_obs.read_journal, registry=RefRegistry,
    faults=ref_faults, propagate=ref_propagate,
    client=ref_loadgen.HttpLoadClient, retry=RefRetryPolicy,
    engine=lambda registry: ref_serve.Engine(registry=registry),
    variables=lambda w: {"w": __import__("jax").numpy.asarray(w)})
PORT = SimpleNamespace(
    name="port", serve=port_serve, journal=RunJournal,
    read_journal=read_journal, registry=Registry, faults=faults,
    propagate=propagate, client=port_loadgen.HttpLoadClient,
    retry=RetryPolicy,
    engine=lambda registry: port_serve.Engine(device="cpu",
                                              registry=registry),
    variables=lambda w: {"w": torch.from_numpy(w)})
PKGS = (REF, PORT)


def toy_fn(variables, images):
    flat = images.reshape((images.shape[0], -1))
    return {"scores": flat @ variables["w"]}


def toy_w(seed=0):
    return np.random.RandomState(seed).randn(16, 3).astype(np.float32)


def an_image(seed=1):
    return np.random.RandomState(seed).rand(*IMG).astype(np.float32)


class FakeBackend:
    """In-memory backend: records calls and the ambient trace context of
    the package `pkg`, answers at once (or with the armed exception)."""

    def __init__(self, pkg, fail_with=None, shed=None):
        self.pkg = pkg
        self.calls = []
        self.ctxs = []
        self.fail_with = fail_with
        self.shed = shed

    def submit(self, model, image, deadline_ms=None):
        if self.shed is not None:
            raise self.pkg.serve.ShedError(model, self.shed)
        self.calls.append((model, deadline_ms))
        self.ctxs.append(self.pkg.propagate.current())
        fut = Future()
        if self.fail_with is not None:
            fut.set_exception(self.fail_with)
        else:
            fut.set_result({"scores": [1.0, 2.0, 3.0]})
        return fut


class StubAdmission:
    """admit() answers from a scripted reason list (None = admitted)."""

    def __init__(self, reasons):
        self.reasons = list(reasons)

    def admit(self, model, queue_depth):
        return self.reasons.pop(0) if self.reasons else None


def post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path,
                     body=body if isinstance(body, bytes)
                     else json.dumps(body).encode("utf-8"),
                     headers=headers or {})
        r = conn.getresponse()
        raw = r.read()
        return (r.status, {k.lower(): v for k, v in r.getheaders()},
                json.loads(raw) if raw else None)
    finally:
        conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


MASKED = ("ts", "run_id", "latency_ms", "trace_id", "span_id",
          "parent_span_id", "port", "pid")


def masked(d):
    return {k: ("<set>" if k in MASKED and d[k] is not None else v)
            for k, v in sorted(d.items())}


def reply(res):
    """(status, headers, body) -> what the contract fixes: the status,
    Retry-After, the traceparent's presence, the body with its latency
    masked."""
    st, hdrs, body = res
    return {"status": st, "retry_after": hdrs.get("retry-after"),
            "traceparent": "traceparent" in hdrs,
            "body": masked(body) if isinstance(body, dict) else body}


class Edge:
    """One package's Transport over `backend`, with a journal of its own."""

    def __init__(self, pkg, tmp, backend=None, **kw):
        self.pkg = pkg
        self.registry = pkg.registry()
        self.journal = pkg.journal(
            os.path.join(str(tmp), f"{pkg.name}.jsonl"), kind="serve")
        self.backend = backend if backend is not None else FakeBackend(pkg)
        kw.setdefault("models", ["toy"])
        self.tp = pkg.serve.Transport(self.backend, journal=self.journal,
                                      registry=self.registry, **kw).start()

    def close(self):
        self.tp.close()
        self.journal.close()

    def rows(self, event="transport_request"):
        return [masked(e) for e in self.pkg.read_journal(self.journal.path)
                if e.get("event") == event]

    def seen(self):
        return {"ledger": self.tp.ledger(), "rows": self.rows(),
                "server_rows": self.rows("transport_server")}


# -- the scenarios: pkg is REF or PORT, tmp a directory ---------------------

def every_shed_reason_maps_to_its_status(pkg, tmp):
    reasons = list(pkg.serve.SHED_REASONS)
    edge = Edge(pkg, tmp, admission=StubAdmission(reasons))
    img = an_image().tolist()
    try:
        replies = [reply(post(edge.tp.port, "/v1/toy", {"image": img}))
                   for _ in range(len(reasons) + 1)]
    finally:
        edge.close()
    return {"table": dict(pkg.serve.STATUS_BY_REASON), "reasons": reasons,
            "replies": replies, **edge.seen()}


def backend_shed_maps_like_admission_shed(pkg, tmp):
    edge = Edge(pkg, tmp, backend=FakeBackend(pkg, shed="queue_full"))
    try:
        r = reply(post(edge.tp.port, "/v1/toy",
                       {"image": an_image().tolist()}))
    finally:
        edge.close()
    return {"reply": r, **edge.seen()}


def replica_lost_is_503_retryable(pkg, tmp):
    edge = Edge(pkg, tmp, backend=FakeBackend(
        pkg, fail_with=pkg.serve.ReplicaLost("p0 died")))
    try:
        r = reply(post(edge.tp.port, "/v1/toy",
                       {"image": an_image().tolist()}))
    finally:
        edge.close()
    return {"reply": r, **edge.seen()}


def backend_errors_are_500(pkg, tmp):
    edge = Edge(pkg, tmp, backend=FakeBackend(
        pkg, fail_with=RuntimeError("boom")))
    try:
        r = reply(post(edge.tp.port, "/v1/toy",
                       {"image": an_image().tolist()}))
    finally:
        edge.close()
    return {"reply": r, **edge.seen()}


def unknown_model_404_bad_body_400(pkg, tmp):
    edge = Edge(pkg, tmp)
    try:
        replies = [reply(post(edge.tp.port, "/v1/nope",
                              {"image": an_image().tolist()})),
                   reply(post(edge.tp.port, "/v1/toy", {"nope": 1})),
                   reply(post(edge.tp.port, "/v1/toy", b"not json at all")),
                   reply(post(edge.tp.port, "/v2/toy", {"image": [1]}))]
    finally:
        edge.close()
    return {"replies": replies, **edge.seen()}


def spent_budget_sheds_at_admission(pkg, tmp):
    edge = Edge(pkg, tmp)
    try:
        r = reply(post(edge.tp.port, "/v1/toy",
                       {"image": an_image().tolist()},
                       {pkg.serve.DEADLINE_HEADER: "0.0001"}))
    finally:
        edge.close()
    assert edge.backend.calls == []  # shed means never executed
    return {"reply": r, **edge.seen()}


def deadline_forwarded_to_backend(pkg, tmp):
    edge = Edge(pkg, tmp)
    try:
        r = reply(post(edge.tp.port, "/v1/toy",
                       {"image": an_image().tolist()},
                       {pkg.serve.DEADLINE_HEADER: "5000"}))
    finally:
        edge.close()
    (model, fwd), = edge.backend.calls
    return {"reply": r, "forwarded": 0 < fwd <= 5000, **edge.seen()}


def default_deadline_comes_from_the_knob(pkg, tmp, monkeypatch):
    monkeypatch.setenv("DVT_TRANSPORT_DEADLINE_MS", "2500")
    monkeypatch.setenv("DVT_TRANSPORT_RETRY_AFTER_MS", "125")
    edge = Edge(pkg, tmp, admission=StubAdmission(["rate_limited"]))
    try:
        replies = [reply(post(edge.tp.port, "/v1/toy",
                              {"image": an_image().tolist()}))
                   for _ in range(2)]
    finally:
        edge.close()
    (model, fwd), = edge.backend.calls
    return {"replies": replies, "forwarded": 0 < fwd <= 2500,
            "default": edge.tp.default_deadline_ms, **edge.seen()}


def unparseable_deadline_header_is_400(pkg, tmp):
    edge = Edge(pkg, tmp)
    try:
        r = reply(post(edge.tp.port, "/v1/toy",
                       {"image": an_image().tolist()},
                       {pkg.serve.DEADLINE_HEADER: "soonish"}))
    finally:
        edge.close()
    return {"reply": r, **edge.seen()}


def dispatch_pickup_past_deadline_sheds_504(pkg, tmp):
    """The real router path: a 5 ms budget into a queue whose max wait is
    80 ms; the dispatcher picks the request up past its deadline and
    sheds it instead of executing it."""
    registry = pkg.registry()
    journal = pkg.journal(os.path.join(str(tmp), f"{pkg.name}.jsonl"),
                          kind="serve")
    eng = pkg.engine(registry)
    eng.register("toy", toy_fn, pkg.variables(toy_w()), input_shape=IMG,
                 buckets=(1, 2))
    eng.warmup()
    server = pkg.serve.Server(eng, journal=journal, registry=registry,
                              max_wait_ms=80.0).start()
    tp = pkg.serve.Transport(server, journal=journal,
                             registry=registry).start()
    try:
        r = reply(post(tp.port, "/v1/toy", {"image": an_image().tolist()},
                       {pkg.serve.DEADLINE_HEADER: "5"}))
        ok = post(tp.port, "/v1/toy", {"image": an_image().tolist()})
    finally:
        tp.close()
        server.drain("close")
        journal.close()
    rows = [masked(e) for e in pkg.read_journal(journal.path)
            if e.get("event") == "transport_request"]
    return {"reply": r, "ok_status": ok[0], "ok_keys": sorted(ok[2]),
            "scores": np.round(np.asarray(ok[2]["outputs"]["scores"]),
                               5).tolist(),
            "ledger": tp.ledger(), "rows": rows}


def traceparent_rides_socket_into_journal(pkg, tmp):
    edge = Edge(pkg, tmp)
    ctx = pkg.propagate.new_trace()
    try:
        r = post(edge.tp.port, "/v1/toy", {"image": an_image().tolist()},
                 {"traceparent": ctx.to_traceparent()})
    finally:
        edge.close()
    echoed = pkg.propagate.from_traceparent(r[1]["traceparent"])
    hop = edge.backend.ctxs[0]
    row = [e for e in pkg.read_journal(edge.journal.path)
           if e.get("event") == "transport_request"][0]
    return {"reply": reply(r),
            "echo_same_trace": echoed.trace_id == ctx.trace_id,
            "echo_new_span": echoed.span_id != ctx.span_id,
            "backend_under_it": hop.trace_id == ctx.trace_id
            and hop.parent_span_id == ctx.span_id,
            "row_linked": row["trace_id"] == ctx.trace_id
            and row["parent_span_id"] == ctx.span_id,
            **edge.seen()}


def malformed_traceparent_starts_a_fresh_trace(pkg, tmp):
    edge = Edge(pkg, tmp)
    try:
        r = post(edge.tp.port, "/v1/toy", {"image": an_image().tolist()},
                 {"traceparent": "00-garbage"})
    finally:
        edge.close()
    fresh = pkg.propagate.from_traceparent(r[1]["traceparent"])
    return {"reply": reply(r), "fresh": fresh is not None
            and fresh.parent_span_id is None, **edge.seen()}


def torn_frame_fails_exactly_one_request(pkg, tmp):
    edge = Edge(pkg, tmp)
    pkg.faults.install_spec("serve.transport:io_error@2", seed=3,
                            journal=edge.journal, export_env=False)
    img = an_image().tolist()
    outcomes = []
    try:
        for _ in range(4):
            try:
                outcomes.append(post(edge.tp.port, "/v1/toy",
                                     {"image": img})[0])
            except (http.client.HTTPException, OSError):
                outcomes.append("torn")
    finally:
        pkg.faults.install(None)
        edge.close()
    assert outcomes == [200, "torn", 200, 200]
    return {"outcomes": outcomes, "faults": edge.rows("fault"),
            **edge.seen()}


def corrupt_frame_is_a_scoped_400(pkg, tmp):
    edge = Edge(pkg, tmp)
    pkg.faults.install_spec("serve.transport:corrupt@2", seed=3,
                            journal=edge.journal, export_env=False)
    img = an_image().tolist()
    try:
        statuses = [post(edge.tp.port, "/v1/toy", {"image": img})[0]
                    for _ in range(3)]
    finally:
        pkg.faults.install(None)
        edge.close()
    assert statuses == [200, 400, 200]
    return {"statuses": statuses, **edge.seen()}


def control_verbs_and_pages(pkg, tmp):
    edge = Edge(pkg, tmp, controls={"echo": lambda p: {"got": p}})
    edge.tp.add_control("fail", lambda p: 1 / 0)
    port = edge.tp.port
    try:
        got = {
            "echo": reply(post(port, "/control/echo", {"x": 1})),
            "fail": reply(post(port, "/control/fail", {})),
            "missing": reply(post(port, "/control/nope", {})),
            "garbled": reply(post(port, "/control/echo", b"{not json")),
            "healthz": get(port, "/healthz"),
            "index": get(port, "/"),
            "nope": get(port, "/nope"),
        }
        post(port, "/v1/toy", {"image": an_image().tolist()})
        got["ledgerz"] = get(port, "/ledgerz")
        got["statusz"] = get(port, "/statusz")
    finally:
        edge.close()
    # the control plane is off the request ledger
    assert got["statusz"][1]["ledger"]["offered"] == 1
    return {**got, "address": edge.tp.address is None,
            "after_close": edge.tp.healthz(), **edge.seen()}


def client_honors_retry_after_and_recovers(pkg, tmp):
    edge = Edge(pkg, tmp,
                admission=StubAdmission(["rate_limited", "queue_full"]),
                retry_after_ms=30.0)
    client = pkg.client("127.0.0.1", edge.tp.port, registry=edge.registry)
    try:
        row = client.submit("toy", an_image()).result(timeout=30)
    finally:
        client.close()
        edge.close()
    return {"row": row, "counts": dict(client.counts), **edge.seen()}


def client_gives_up_typed_when_budget_exhausts(pkg, tmp):
    edge = Edge(pkg, tmp, admission=StubAdmission(["queue_full"] * 10),
                retry_after_ms=1.0)
    client = pkg.client(
        "127.0.0.1", edge.tp.port,
        retry=pkg.retry(name="t", max_attempts=2, base_delay_s=0.001,
                        jitter=0.0, retry_on=(pkg.serve.ShedError,)))
    try:
        with pytest.raises(pkg.serve.ShedError) as ei:
            client.submit("toy", an_image()).result(timeout=30)
    finally:
        client.close()
        edge.close()
    return {"reason": ei.value.reason, "counts": dict(client.counts),
            **edge.seen()}


def client_types_each_terminal_verdict(pkg, tmp):
    edge = Edge(pkg, tmp, admission=StubAdmission([None, None, None]))
    client = pkg.client(
        "127.0.0.1", edge.tp.port,
        retry=pkg.retry(name="t", max_attempts=1, jitter=0.0))
    got = []
    try:
        for model in ("nope", "toy"):
            try:
                client.submit(model, an_image()).result(timeout=30)
                got.append("ok")
            except Exception as e:
                got.append(type(e).__name__)
        edge.backend.fail_with = pkg.serve.ReplicaLost("gone")
        try:
            client.submit("toy", an_image()).result(timeout=30)
        except Exception as e:
            got.append(type(e).__name__)
        client.deadline_ms = 0.0001
        try:
            client.submit("toy", an_image()).result(timeout=30)
        except Exception as e:
            got.append(type(e).__name__)
    finally:
        client.close()
        edge.close()
    return {"got": got, "counts": dict(client.counts), **edge.seen()}


SCENARIOS = {f.__name__: f for f in (
    every_shed_reason_maps_to_its_status,
    backend_shed_maps_like_admission_shed, replica_lost_is_503_retryable,
    backend_errors_are_500, unknown_model_404_bad_body_400,
    spent_budget_sheds_at_admission, deadline_forwarded_to_backend,
    default_deadline_comes_from_the_knob,
    unparseable_deadline_header_is_400,
    dispatch_pickup_past_deadline_sheds_504,
    traceparent_rides_socket_into_journal,
    malformed_traceparent_starts_a_fresh_trace,
    torn_frame_fails_exactly_one_request, corrupt_frame_is_a_scoped_400,
    control_verbs_and_pages, client_honors_retry_after_and_recovers,
    client_gives_up_typed_when_budget_exhausts,
    client_types_each_terminal_verdict)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faults, ref_faults):
        mod.install(None)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_the_reference(name, tmp_path, monkeypatch):
    fn = SCENARIOS[name]
    kw = {"monkeypatch": monkeypatch} \
        if "monkeypatch" in fn.__code__.co_varnames else {}
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        d.mkdir()
        got[pkg.name] = fn(pkg, d, **kw)
    assert got["port"] == got["ref"]


def test_the_contract_tables_are_the_references():
    for name in ("STATUS_BY_REASON", "TRANSPORT_OUTCOMES",
                 "TRANSPORT_SERVER_OUTCOMES", "DEADLINE_HEADER"):
        assert getattr(port_serve, name) == \
            getattr(ref_serve.transport, name), name
    assert set(port_serve.STATUS_BY_REASON) == set(port_serve.SHED_REASONS)
    assert "serve.transport" in faults.POINTS
    for name in ("DVT_TRANSPORT_DEADLINE_MS", "DVT_TRANSPORT_RETRY_AFTER_MS",
                 "DVT_RDZV_GENERATION"):
        assert knobs.KNOBS[name].kind == ref_knobs.KNOBS[name].kind
        assert knobs.KNOBS[name].default == ref_knobs.KNOBS[name].default


def test_check_journal_accepts_the_ports_edge_journal(tmp_path):
    from tools.check_journal import check_journal

    edge = Edge(PORT, tmp_path, admission=StubAdmission(["rate_limited"]))
    try:
        for _ in range(2):
            post(edge.tp.port, "/v1/toy", {"image": an_image().tolist()})
    finally:
        edge.close()
    assert check_journal(edge.journal.path, strict=True) == []


def test_outputs_go_to_json_in_every_form_the_server_answers():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert _jsonable_outputs({"a": arr, "n": np.int32(3)}) == \
        {"a": arr.tolist(), "n": 3}
    assert _jsonable_outputs((arr, arr[0])) == [arr.tolist(),
                                                arr[0].tolist()]
    assert _jsonable_outputs(arr) == arr.tolist()
    assert _jsonable_outputs(torch.from_numpy(arr)) == arr.tolist()
    for row in ({"a": arr}, (arr, arr), arr, None, 1.5, "s"):
        assert _jsonable_outputs(row) == \
            ref_serve.transport._jsonable_outputs(row)


def test_the_ports_client_carries_the_callers_trace(tmp_path):
    """The port's client sends the context installed on the thread that
    calls submit(); the reference's reads it on its worker thread, where
    none is installed, so the front door roots a fresh trace."""
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        d.mkdir()
        edge = Edge(pkg, d)
        client = pkg.client("127.0.0.1", edge.tp.port)
        ctx = pkg.propagate.new_trace()
        try:
            with pkg.propagate.use(ctx):
                client.submit("toy", an_image()).result(timeout=30)
        finally:
            client.close()
            edge.close()
        row = [e for e in pkg.read_journal(edge.journal.path)
               if e.get("event") == "transport_request"][0]
        got[pkg.name] = (row["trace_id"] == ctx.trace_id,
                         edge.backend.ctxs[0].trace_id == ctx.trace_id)
    assert got == {"ref": (False, False), "port": (True, True)}
