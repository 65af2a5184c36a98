"""The port's flight recorder (deep_vision_tpu_torch/obs/flight.py)
against the JAX package's.

The same journal rows, notes, metrics and spans, drawn from a numpy
seed, go into both recorders with the clock frozen; their bundles hold
the same files with the same bytes, and manifests equal but for two
entries: the thread stacks (which name each package's own source lines;
the same threads) and the span tail (equal with pid and tid masked). Each package's `validate_bundle` accepts the other's
bundle and rejects the same truncations with the same messages. Also:
the per-reason dump latch, no clobbering of a prior run's bundle, the
atexit dump only while armed, the requeue latch, and health events
reaching a recorder with no journal (abort and hang).
"""
import json
import os
import shutil
import time

import numpy as np
import pytest

from deep_vision_tpu.obs import flight as ref_flight
from deep_vision_tpu.obs import trace as ref_trace
from deep_vision_tpu.obs.health import HealthMonitor as RefHealthMonitor
from deep_vision_tpu.obs.health import TrainingHealthError as RefHealthError
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu_torch.obs import flight, trace
from deep_vision_tpu_torch.obs.health import HealthMonitor, TrainingHealthError
from deep_vision_tpu_torch.obs.registry import Registry

FROZEN = 1_700_000_000.125


@pytest.fixture(autouse=True)
def _no_active_recorders():
    yield
    flight.set_flight(None)
    ref_flight.set_flight(None)
    flight.clear_requeue()


def rows(seed, n=40):
    """Journal rows of every kind the recorder routes: steps, health
    events (no hang or abort: those dump), notes and others."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = rng.randint(4)
        row = {"ts": round(FROZEN + i, 3), "run_id": "run-7"}
        if kind == 0:
            row.update(event="step", step=i, loss=float(rng.rand()),
                       lr=0.1, skipped=False)
        elif kind == 1:
            row.update(event="health", kind="loss_spike", step=i,
                       z=float(rng.rand() * 10), monitor="train")
        elif kind == 2:
            row.update(event="note", note=f"n{rng.randint(5)}",
                       value=[1, 2.5, None])
        else:
            row.update(event="checkpoint", step=i, saved=bool(i % 2))
        out.append(row)
    return out


def fill(mod, reg_cls, trace_mod, seed, tmp, max_steps=8):
    """A recorder of `mod` fed the seeded rows, notes and a registry;
    spans come from an installed tracer of `trace_mod`."""
    rng = np.random.RandomState(seed + 100)
    reg = reg_cls()
    reg.counter("c_total", "a counter", labels={"k": "v"}).inc(3)
    reg.gauge("g", "a gauge").set(float("nan"))
    h = reg.histogram("h_ms", "a histogram")
    for v in rng.rand(20) * 100:
        h.observe(v)
    fr = mod.FlightRecorder(tmp, run_id="run-7", max_steps=max_steps,
                            max_health=4, max_tail=16, max_notes=3,
                            registry=reg)
    for r in rows(seed):
        fr.observe(dict(r))
    for i in range(5):
        fr.note("data_worker_restart", loader="train", worker=i,
                delivered=np.int64(10 * i), restart=i, budget=3)
    return fr


def bundle_files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("seed", [0, 1])
def test_same_inputs_same_bundle(tmp_path, monkeypatch, seed):
    monkeypatch.setattr(time, "time", lambda: FROZEN)
    bundles = []
    for mod, reg_cls, tmod in ((flight, Registry, trace),
                               (ref_flight, RefRegistry, ref_trace)):
        tr = tmod.Tracer(str(tmp_path / f"{mod.__name__}.trace.json"))
        tmod.set_tracer(tr)
        try:
            for i in range(4):
                tr.event(f"span{i}", 10.0 * i, 10.0 * i + 5, step=i)
            fr = fill(mod, reg_cls, tmod, seed,
                      str(tmp_path / mod.__name__))
            path = fr.dump("manual")
        finally:
            tmod.set_tracer(None)
            tr.close()
            fr.close()
        bundles.append(path)
    got, want = bundles
    assert os.path.basename(got) == os.path.basename(want) == \
        "run-7-manual"
    gf, wf = bundle_files(got), bundle_files(want)
    assert sorted(gf) == sorted(wf) == sorted(
        list(flight._PAYLOAD_FILES) + ["MANIFEST.json"])
    for name in gf:
        if name in ("MANIFEST.json", "stacks.json", "spans.json"):
            continue
        assert gf[name] == wf[name], name
    gs, ws = json.loads(gf["spans.json"]), json.loads(wf["spans.json"])
    for doc in (gs, ws):
        for e in doc["traceEvents"]:
            e.pop("pid"), e.pop("tid")
    assert gs == ws and len(gs["traceEvents"]) == 5  # thread name + 4
    gm, wm = json.loads(gf["MANIFEST.json"]), json.loads(wf["MANIFEST.json"])
    for m in (gm, wm):
        m["files"].pop("stacks.json")
        m["files"].pop("spans.json")
    assert gm == wm and gm["ts"] == round(FROZEN, 3)
    assert gm["process_index"] == 0 and gm["reason"] == "manual"
    assert set(json.loads(gf["stacks.json"])) == \
        set(json.loads(wf["stacks.json"]))
    steps = [json.loads(x) for x in gf["steps.jsonl"].splitlines()]
    assert len(steps) == 8 and all(r["event"] == "step" for r in steps)
    notes = [json.loads(x) for x in gf["notes.jsonl"].splitlines()]
    assert [n["worker"] for n in notes] == [2, 3, 4]
    assert notes[0]["delivered"] == 20.0
    assert "c_total{k=\"v\"} 3" in gf["metrics.prom"].decode()
    for a, b in ((got, want), (want, got)):
        assert flight.validate_bundle(b) == []
        assert ref_flight.validate_bundle(a) == []


def _damage(path, how):
    if how == "truncate_payload":
        p = os.path.join(path, "steps.jsonl")
        data = open(p, "rb").read()
        open(p, "wb").write(data[:len(data) // 2])
    elif how == "flip_byte":
        p = os.path.join(path, "journal_tail.jsonl")
        data = bytearray(open(p, "rb").read())
        data[3] ^= 0x01
        open(p, "wb").write(bytes(data))
    elif how == "delete_payload":
        os.remove(os.path.join(path, "metrics.prom"))
    elif how == "truncate_manifest":
        p = os.path.join(path, "MANIFEST.json")
        data = open(p, "rb").read()
        open(p, "wb").write(data[:40])
    elif how == "manifest_fields":
        p = os.path.join(path, "MANIFEST.json")
        m = json.load(open(p))
        del m["reason"], m["ts"]
        json.dump(m, open(p, "w"))


@pytest.mark.parametrize("how", ["truncate_payload", "flip_byte",
                                 "delete_payload", "truncate_manifest",
                                 "manifest_fields"])
def test_both_validators_reject_the_same_damage(tmp_path, how):
    fr = fill(flight, Registry, trace, 3, str(tmp_path / "src"))
    src = fr.dump("crash")
    fr.close()
    errors = {}
    for name, mod in (("port", flight), ("ref", ref_flight)):
        copy = str(tmp_path / name / "b")
        shutil.copytree(src, copy)
        _damage(copy, how)
        errors[name] = [e.replace(copy, "<bundle>")
                        for e in mod.validate_bundle(copy)]
    assert errors["port"] and errors["port"] == errors["ref"]
    # the other package's validator on the damaged port copy
    assert [e.replace(str(tmp_path / "port" / "b"), "<bundle>")
            for e in ref_flight.validate_bundle(
                str(tmp_path / "port" / "b"))] == errors["port"]


def test_latch_no_clobber_and_find_bundles(tmp_path):
    d = str(tmp_path / "fl")
    fr = flight.FlightRecorder(d, run_id="r")
    first = fr.dump("hang")
    assert fr.dump("hang") == first  # latched per reason
    crash = fr.dump("crash")
    assert crash != first and fr.dumped == {"hang": first, "crash": crash}
    fr.close()
    fr2 = flight.FlightRecorder(d, run_id="r")  # a later run, same id
    again = fr2.dump("hang")
    fr2.close()
    assert again.endswith("r-hang-2") and os.path.isdir(first)
    os.makedirs(os.path.join(d, "r-crash.tmp-123"))  # a torn dump
    open(os.path.join(d, "stray.txt"), "w").close()
    assert flight.find_bundles(d) == sorted([first, crash, again])
    assert flight.find_bundles(str(tmp_path / "none")) == []
    assert all(flight.validate_bundle(b) == []
               for b in flight.find_bundles(d))
    # the journal hears of each dump
    events = []

    class J:
        def add_tap(self, fn):
            pass

        def write(self, event, **fields):
            events.append((event, fields))

    fr3 = flight.FlightRecorder(str(tmp_path / "fl3"), run_id="j")
    fr3.attach(J())
    path = fr3.dump("manual")
    fr3.close()
    assert events == [("flight_dump", {"reason": "manual", "dir": path,
                                       "outcome": "written"})]


def test_atexit_dumps_only_while_armed(tmp_path):
    d = str(tmp_path / "fl")
    fr = flight.FlightRecorder(d, run_id="armed")
    fr._atexit()  # what the interpreter runs at exit
    assert [os.path.basename(b) for b in flight.find_bundles(d)] == \
        ["armed-crash"]
    fr.close()
    fr2 = flight.FlightRecorder(d, run_id="clean")
    flight.set_flight(fr2)
    fr2.close()
    assert flight.get_flight() is None  # close detaches the global
    fr2._atexit()
    assert len(flight.find_bundles(d)) == 1
    assert flight.emergency_dump("preempt") is None  # none installed


def test_requeue_latch():
    assert flight.REQUEUE_EXIT_CODE == ref_flight.REQUEUE_EXIT_CODE == 75
    assert flight.REASONS == ref_flight.REASONS
    flight.clear_requeue()
    assert not flight.requeue_requested()
    flight.request_requeue()
    assert flight.requeue_requested()
    flight.clear_requeue()
    assert not flight.requeue_requested()


def test_observe_dumps_on_hang_and_abort_but_not_serve_abort(tmp_path):
    d = str(tmp_path / "fl")
    fr = flight.FlightRecorder(d, run_id="o")
    fr.observe({"event": "health", "kind": "non_finite", "action": "abort",
                "monitor": "serve"})
    assert flight.find_bundles(d) == []
    fr.observe({"event": "health", "kind": "non_finite", "action": "abort",
                "monitor": "train"})
    fr.observe({"event": "health", "kind": "hang", "monitor": "train"})
    fr.close()
    assert [os.path.basename(b) for b in flight.find_bundles(d)] == \
        ["o-hang", "o-health_abort"]


@pytest.mark.parametrize("kind", ["abort", "hang"])
def test_health_reaches_a_journal_less_recorder(tmp_path, kind):
    names = {}
    for mod, health_cls, err, reg in (
            (flight, HealthMonitor, TrainingHealthError, Registry),
            (ref_flight, RefHealthMonitor, RefHealthError, RefRegistry)):
        d = str(tmp_path / mod.__name__)
        fr = mod.FlightRecorder(d, run_id="h")
        mod.set_flight(fr)
        try:
            if kind == "abort":
                h = health_cls(policy="abort", registry=reg())
                with pytest.raises(err):
                    h.check_step(3, loss=float("nan"), grad_norm=1.0)
            else:
                h = health_cls(watchdog_timeout=0.2, registry=reg())
                h.start_watchdog()
                deadline = time.time() + 10
                while not mod.find_bundles(d) and time.time() < deadline:
                    time.sleep(0.05)
                h.stop()
        finally:
            fr.close()
            mod.set_flight(None)
        bundles = mod.find_bundles(d)
        names[mod.__name__] = [os.path.basename(b) for b in bundles]
        health = [json.loads(x) for x in open(os.path.join(
            bundles[0], "health.jsonl"))]
        for row in health:
            row.pop("ts")
            assert row.pop("stacks", {}) is not None
            row.pop("stalled_s", None)
        names[mod.__name__].append(health)
    assert names["deep_vision_tpu_torch.obs.flight"] == \
        names["deep_vision_tpu.obs.flight"]
    want = "h-health_abort" if kind == "abort" else "h-hang"
    assert names["deep_vision_tpu_torch.obs.flight"][0] == want
