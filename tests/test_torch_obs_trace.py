"""The port's span tracer and trace context (deep_vision_tpu_torch/obs/
trace.py, propagate.py) against the JAX package's.

The same script of nested spans, explicit events, trace contexts and
threads, drawn from a numpy seed, runs through both Tracers; their
`traceEvents` agree in names, `ph`, args, nesting and thread-name
metadata, with times, pids and thread ids masked. Also: the ring-buffer
cap and its drop count, a file that is valid JSON while the tracer is
still open, the null span without a tracer, check_trace on the port's
file, and `from_traceparent` over valid and malformed strings
(hypothesis).
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deep_vision_tpu.obs import propagate as ref_propagate
from deep_vision_tpu.obs import trace as ref_trace
from deep_vision_tpu_torch.obs import propagate, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN_ID = "00f067aa0ba902b7"


def _args(rng):
    """A span's args: ints, floats (a NaN and an inf among them),
    strings, bools, None and an object that only repr() can write."""
    kinds = rng.randint(0, 7, size=rng.randint(0, 4))
    out = {}
    for i, k in enumerate(kinds):
        out[f"a{i}"] = [int(rng.randint(-5, 50)), float(rng.rand()),
                        f"s{rng.randint(9)}", bool(rng.randint(2)), None,
                        float("nan") if rng.randint(2) else float("inf"),
                        np.float32(rng.rand())][k]
    return out


def run_script(mod, prop, seed, path):
    """Nested spans, explicit events, a context and worker threads,
    through `mod`'s module-level API on a Tracer at `path`."""
    rng = np.random.RandomState(seed)
    tracer = mod.Tracer(path, run_id="run-1", flush_every=7)
    mod.set_tracer(tracer)
    try:
        def nest(depth, prefix):
            for i in range(rng.randint(1, 3)):
                name = f"{prefix}/{i}"
                with mod.span(name, **_args(rng)) as sp:
                    if rng.randint(2):
                        sp.set(step=int(rng.randint(100)))
                    if depth < 3 and rng.randint(3):
                        nest(depth + 1, name)
                    if rng.randint(3) == 0:
                        t0 = mod.now_us()
                        mod.trace_event(f"{name}/event", t0,
                                        **_args(rng))
            if rng.randint(2):
                try:
                    with mod.span(f"{prefix}/raises"):
                        raise KeyError("x")
                except KeyError:
                    pass

        nest(0, "main")
        ctx = prop.TraceContext(TRACE_ID, SPAN_ID)
        with prop.use(ctx):
            with mod.span("traced", model="m"):
                pass
            with mod.span("traced_own", trace_id="given"):
                pass
        for w in range(2):  # threads one after another: a fixed order
            t = threading.Thread(target=nest, args=(1, f"worker{w}"),
                                 name=f"worker-{w}")
            t.start()
            t.join()
        nest(1, "main_again")
    finally:
        mod.set_tracer(None)
        tracer.close()
    with open(path) as f:
        return json.load(f)


def masked(doc):
    """traceEvents with ts/dur/pid/tid masked, each complete event
    carrying its parent: the innermost span of its own thread that
    encloses it (computed from the times before they are masked); a
    thread id becomes the name its latest metadata event gave it (the OS
    reuses the ids of finished threads)."""
    events = doc["traceEvents"]
    names = {}
    spans = [e for e in events if e["ph"] == "X"]
    out = []
    for e in events:
        if e["ph"] == "M":
            names[e["tid"]] = e["args"]["name"]
        row = {k: v for k, v in e.items()
               if k not in ("ts", "dur", "pid", "tid")}
        row["thread"] = names.get(e["tid"])
        if e["ph"] == "X":
            enclosing = [p for p in spans if p is not e
                         and p["tid"] == e["tid"]
                         and p["ts"] <= e["ts"]
                         and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                         and p["name"] != e["name"]]
            parent = min(enclosing, key=lambda p: p["dur"], default=None)
            row["parent"] = parent["name"] if parent else None
        out.append(row)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_script_same_trace_events(tmp_path, seed):
    got = run_script(trace, propagate, seed, str(tmp_path / "port.json"))
    want = run_script(ref_trace, ref_propagate, seed,
                      str(tmp_path / "ref.json"))
    assert masked(got) == masked(want)
    assert got["metadata"]["run_id"] == want["metadata"]["run_id"]
    assert got["metadata"]["dropped_events"] == \
        want["metadata"]["dropped_events"] == 0
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    names = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M"}
    assert {"worker-0", "worker-1"} <= names
    traced = next(e for e in got["traceEvents"] if e["name"] == "traced")
    assert traced["args"]["trace_id"] == TRACE_ID
    from tools.check_journal import check_trace

    assert check_trace(str(tmp_path / "port.json")) == []


@pytest.mark.parametrize("n", [999, 1500])
def test_ring_buffer_cap_and_drop_count(tmp_path, n):
    docs = []
    for mod in (trace, ref_trace):
        path = str(tmp_path / f"{mod.__name__}.json")
        t = mod.Tracer(path, max_events=10, flush_every=10_000)
        for i in range(n):
            t.event(f"e{i % 3}", 0.0, 1.0, i=i)
        assert t.num_events <= t.max_events == 1000
        tail = t.tail(5)
        t.close()
        docs.append((json.load(open(path)), [e.get("args") for e in tail]))
    (got, got_tail), (want, want_tail) = docs
    assert got["metadata"]["dropped_events"] == \
        want["metadata"]["dropped_events"]
    assert (got["metadata"]["dropped_events"] > 0) == (n > 999)
    assert masked(got) == masked(want)
    assert got_tail == want_tail


def test_file_is_valid_json_mid_run(tmp_path):
    from tools.check_journal import check_trace

    path = str(tmp_path / "live.json")
    t = trace.Tracer(path, flush_every=1)
    try:
        for i in range(5):
            with t.span("step", step=i):
                pass
            doc = json.load(open(path))
            assert len([e for e in doc["traceEvents"]
                        if e["ph"] == "X"]) == i + 1
            assert check_trace(path) == []
    finally:
        t.close()
    assert not os.path.exists(path + ".tmp")


def test_null_span_without_a_tracer(tmp_path):
    assert trace.get_tracer() is None
    sp = trace.span("x", a=1)
    assert sp is trace.span("y") is trace._NULL_SPAN
    with sp as s:
        s.set(step=3)
    trace.trace_event("nothing", trace.now_us())
    assert not os.listdir(tmp_path)

    calls = []

    @trace.traced("work", kind="t")
    def work(x):
        calls.append(x)
        return x + 1

    assert work(1) == 2 and calls == [1]
    t = trace.Tracer(str(tmp_path / "t.json"))
    trace.set_tracer(t)
    try:
        assert work(2) == 3
    finally:
        trace.set_tracer(None)
        t.close()
    (ev,) = [e for e in json.load(open(tmp_path / "t.json"))["traceEvents"]
             if e["ph"] == "X"]
    assert ev["name"] == "work" and ev["args"] == {"kind": "t"}
    assert work.__wrapped__.__name__ == "work"


# -- propagate -----------------------------------------------------------------

def _as_tuple(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id,
                                     ctx.parent_span_id)


HEX = "0123456789abcdef"
VALID = st.builds(
    lambda v, t, s, f: f"{v}-{t}-{s}-{f}",
    st.text(HEX, min_size=2, max_size=2), st.text(HEX, min_size=32,
                                                   max_size=32),
    st.text(HEX, min_size=16, max_size=16),
    st.text(HEX, min_size=2, max_size=2))


@settings(max_examples=300, deadline=None)
@given(st.one_of(
    VALID,
    VALID.map(str.upper),
    VALID.map(lambda s: " " + s + "\n"),
    VALID.map(lambda s: s[:-1]),
    VALID.map(lambda s: s.replace("-", "_", 1)),
    VALID.map(lambda s: s.encode("ascii")),
    st.text(max_size=60),
    st.binary(max_size=60),
    st.none(), st.integers(), st.floats(allow_nan=False)))
def test_from_traceparent_matches_the_reference(value):
    assert _as_tuple(propagate.from_traceparent(value)) == \
        _as_tuple(ref_propagate.from_traceparent(value))


@pytest.mark.parametrize("value", [
    f"00-{TRACE_ID}-{SPAN_ID}-01", f"ff-{TRACE_ID}-{SPAN_ID}-01",
    f"00-{'0' * 32}-{SPAN_ID}-01", f"00-{TRACE_ID}-{'0' * 16}-01",
    f"00-{TRACE_ID.upper()}-{SPAN_ID}-01", b"\xff\xfe",
    f"00-{TRACE_ID}-{SPAN_ID}-01".encode(), f"  00-{TRACE_ID}-{SPAN_ID}-01 "])
def test_from_traceparent_edge_cases(value):
    got = propagate.from_traceparent(value)
    assert _as_tuple(got) == _as_tuple(ref_propagate.from_traceparent(value))


def test_context_ids_children_and_the_ambient_slot():
    ctx = propagate.new_trace()
    assert propagate.valid_trace_id(ctx.trace_id)
    assert propagate.valid_span_id(ctx.span_id)
    assert ctx.parent_span_id is None and "parent_span_id" not in \
        ctx.fields()
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    assert child.fields() == {"trace_id": ctx.trace_id,
                              "span_id": child.span_id,
                              "parent_span_id": ctx.span_id}
    wire = ctx.to_traceparent()
    assert propagate.from_traceparent(wire) == ctx
    assert ref_propagate.from_traceparent(wire).fields() == ctx.fields()
    assert propagate.current() is None
    with propagate.use(ctx):
        assert propagate.current() is ctx
        with propagate.use(None):
            assert propagate.current() is None
        seen = []
        t = threading.Thread(target=lambda: seen.append(propagate.current()))
        t.start()
        t.join()
        assert seen == [None]  # the slot is per thread
        assert propagate.current() is ctx
    assert propagate.current() is None
    assert propagate.TRACE_FIELDS == ref_propagate.TRACE_FIELDS
