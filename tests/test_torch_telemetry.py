"""The port's live telemetry plane (deep_vision_tpu_torch/obs/telemetry.py)
against the JAX package's obs/telemetry.py, both served in this process.

Endpoints: a reference and a port Registry take the same counters,
gauges (labelled too) and histograms, each is served through its own
package's TelemetryServer, and the /metrics and /varz bodies are equal;
both packages' `validate_prometheus` agree on good and broken bodies;
the /healthz aggregation over the same sources is equal (a raising
source: 503 and its error entry); /statusz has the reference's keys in
JSON and `?format=html`; /alertz answers the reference's empty lists,
and an attached alert engine's state alike; an unknown route is a 404;
registration by name replaces. Lifecycle: the discovery file has the
reference's name and fields and each package's `read_discovery` reads
the other's (a garbled file skipped); a bind conflict journals `failed`
and raises; the `telemetry_server` rows pass
`tools/check_journal.py --strict`; `TELEMETRY_OUTCOMES` is the
reference's and check_journal's. The parts the endpoints read:
`FlightRecorder.tail`, `RunJournal.manifest_row` and the perf status
(obs/perfwatch.py).
"""
import json
import os
import sys
import urllib.error
import urllib.request

import pytest

from deep_vision_tpu.obs import RunJournal as RefJournal
from deep_vision_tpu.obs import perfwatch as ref_perfwatch
from deep_vision_tpu.obs import read_journal as ref_read_journal
from deep_vision_tpu.obs import telemetry as ref_tele
from deep_vision_tpu.obs.flight import FlightRecorder as RefFlight
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu_torch.obs import TelemetryServer, perfwatch
from deep_vision_tpu_torch.obs import telemetry as tele
from deep_vision_tpu_torch.obs.flight import FlightRecorder
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.check_journal import (  # noqa: E402
    TELEMETRY_SERVER_OUTCOMES,
    check_journal,
)

PACKAGES = {
    "ref": (ref_tele.TelemetryServer, RefRegistry, RefJournal),
    "port": (TelemetryServer, Registry, RunJournal),
}


def get(address, path, timeout=10.0):
    """(status, content type, body); an HTTP error returns its code."""
    try:
        with urllib.request.urlopen(f"http://{address}{path}",
                                    timeout=timeout) as resp:
            return (resp.status, resp.headers.get("Content-Type", ""),
                    resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return (e.code, e.headers.get("Content-Type", ""),
                e.read().decode("utf-8"))


def populate(reg):
    """The same metrics, in the same order, into either package's
    Registry."""
    reg.counter("requests_total", "requests").inc(3)
    reg.counter("shed_total", "sheds", labels={"reason": "queue_full"}).inc()
    reg.counter("shed_total", "sheds", labels={"reason": "rate"}).inc(2)
    reg.gauge("queue_depth", "depth").set(4)
    reg.gauge("temp", "a labelled gauge",
              labels={"model": "yolov3", "replica": "r0"}).set(0.25)
    reg.gauge("nan_gauge").set(float("nan"))
    h = reg.histogram("step_ms", "step time")
    for v in (0.5, 3.0, 17.0, 17.5, 250.0, 2e6):
        h.observe(v)
    reg.histogram("lat_ms", "latency", buckets=(1.0, 10.0),
                  labels={"model": "m"}).observe(5.0)
    reg.counter("excache_hits_total", "cache hits").inc(2)


@pytest.fixture
def pair(tmp_path):
    """{"ref": server, "port": server}, started, each over its package's
    Registry (populated alike) and RunJournal, role "test", discovery
    files under tmp_path/<name>."""
    servers = {}
    for name, (server_cls, reg_cls, journal_cls) in PACKAGES.items():
        reg = reg_cls()
        populate(reg)
        j = journal_cls(str(tmp_path / f"{name}.jsonl"), kind="train")
        t = server_cls(port=0, role="test", registry=reg, journal=j,
                       discovery_dir=str(tmp_path / name))
        t.journal_ref = j
        servers[name] = t.start()
    yield servers
    for t in servers.values():
        t.close()
        if not t.journal_ref._closed:
            t.journal_ref.close()


def both(pair, path):
    return {name: get(t.address, path) for name, t in pair.items()}


# -- endpoints ---------------------------------------------------------------

@pytest.mark.parametrize("path", ["/metrics", "/varz"])
def test_metrics_and_varz_bodies_are_the_references(pair, path):
    got = both(pair, path)
    assert got["port"] == got["ref"]
    code, ctype, body = got["port"]
    assert code == 200
    if path == "/metrics":
        assert ctype.startswith("text/plain")
        assert tele.validate_prometheus(body) == []
        assert 'temp{model="yolov3",replica="r0"} 0.25' in body
    else:
        assert ctype.startswith("application/json")
        varz = json.loads(body)
        assert varz["queue_depth"] == 4
        assert varz["step_ms"]["count"] == 6 and varz["step_ms"]["p99"] \
            is None  # above the top bucket: +Inf, written as null


BAD_BODIES = [
    "",
    "# TYPE a counter\na 1\n",
    "# TYPE a counter\na 1\n# TYPE b gauge\nb 2\na 3\n",
    "# TYPE a counter\na 1\n# TYPE a counter\na 2\n",
    "# TYPE a bogus\na 1\n",
    "# TYPE a gauge\na one\n",
    "# TYPE a gauge\na{x=\"1\" 2\n",
    "# TYPE a gauge\na NaN\na{k=\"v\"} +Inf\n",
    "b 1\n",
    "# HELP a h\n# TYPE a histogram\na_bucket{le=\"+Inf\"} 1\na_sum 2\n"
    "a_count 1\n",
    "# TYPE a\n",
]


@pytest.mark.parametrize("body", BAD_BODIES)
def test_validate_prometheus_agrees_with_the_reference(body):
    assert tele.validate_prometheus(body) == \
        ref_tele.validate_prometheus(body)


def test_the_exports_validate_in_both_packages(pair):
    reg = Registry()
    populate(reg)
    text = reg.to_prometheus()
    assert tele.validate_prometheus(text) == [] == \
        ref_tele.validate_prometheus(text)


def boom():
    raise RuntimeError("probe exploded")


def test_healthz_aggregation_is_the_references(pair):
    assert both(pair, "/healthz")["port"][0] == 200  # no source: healthy
    for t in pair.values():
        t.add_health("good", lambda: (True, {"x": 1}))
    got = both(pair, "/healthz")
    assert got["port"] == got["ref"] and got["port"][0] == 200
    for t in pair.values():
        t.add_health("bad", lambda: (False, {"why": "down"}))
        t.add_health("boom", boom)
    got = both(pair, "/healthz")
    assert got["port"] == got["ref"]
    code, _, body = got["port"]
    row = json.loads(body)
    assert code == 503 and row["ok"] is False
    assert row["checks"]["good"]["ok"] is True
    assert row["checks"]["bad"]["why"] == "down"
    assert row["checks"]["boom"] == {
        "ok": False, "error": "RuntimeError: probe exploded"}


def test_statusz_has_the_references_keys(pair, tmp_path):
    for name, t in pair.items():
        t.journal_ref.manifest(config={"name": "t5", "task": "clf"})
        t.add_status("train", lambda: {"step": 12, "epoch": 1})
        t.add_status("boom", boom)  # renders as an error entry, never a 500
    rows = {}
    for name, t in pair.items():
        code, ctype, body = get(t.address, "/statusz")
        assert code == 200 and ctype.startswith("application/json")
        rows[name] = json.loads(body)
    port, ref = rows["port"], rows["ref"]
    assert sorted(port) == sorted(ref)
    assert port["status"] == ref["status"] == {
        "train": {"step": 12, "epoch": 1},
        "boom": {"error": "RuntimeError: probe exploded"}}
    assert port["excache"] == ref["excache"] == {"excache_hits_total": 2.0}
    assert port["health"] == ref["health"] and port["healthy"] is True
    assert port["manifest"] == pair["port"].journal_ref.manifest_row()
    assert port["manifest"]["config"] == ref["manifest"]["config"]
    assert port["recent_events"] == ref["recent_events"] == []
    assert port["role"] == "test" and port["address"] == \
        pair["port"].address and port["pid"] == os.getpid()
    html = {name: get(t.address, "/statusz?format=html")
            for name, t in pair.items()}
    code, ctype, body = html["port"]
    assert code == 200 and ctype.startswith("text/html")
    assert "HEALTHY" in body and "statusz" in body
    for section in ("status", "health", "excache", "manifest",
                    "recent_events"):
        assert f"<h2>{section}</h2>" in body
        assert f"<h2>{section}</h2>" in html["ref"][2]
    assert tele._statusz_html(ref) == ref_tele._statusz_html(ref)


def test_unknown_route_is_404_and_the_index_lists_the_routes(pair):
    got = both(pair, "/nope")
    assert got["port"] == got["ref"] and got["port"][0] == 404
    got = both(pair, "/")
    assert got["port"] == got["ref"]
    assert got["port"][0] == 200 and "/alertz" in got["port"][2]


class Engine:
    """An alert engine's two reads, as obs/alerts.py's AlertEngine."""

    def __init__(self, active):
        self._active = active

    def active(self):
        return list(self._active)

    def alertz(self):
        return {"now": 12.5, "active": self.active(), "history": [],
                "rules": [{"rule": "slo_burn"}]}


def test_alertz_is_the_references_without_and_with_an_engine(pair):
    got = both(pair, "/alertz")
    assert got["port"] == got["ref"]
    assert json.loads(got["port"][2]) == {"now": None, "active": [],
                                          "history": [], "rules": []}
    engine = Engine([{"rule": "slo_burn", "severity": "page"}])
    for t in pair.values():
        t.set_alerts(engine)
    for path in ("/alertz", "/healthz"):
        got = both(pair, path)
        assert got["port"] == got["ref"]
    assert got["port"][0] == 503
    assert json.loads(got["port"][2])["checks"]["alerts"] == {
        "active": 1, "paging": ["slo_burn"], "ok": False}


def test_registration_by_name_replaces(pair):
    for t in pair.values():
        t.add_status("s", lambda: {"v": 1})
        t.add_status("s", lambda: {"v": 2})
        t.add_health("s", lambda: (False, {}))
        t.add_health("s", lambda: (True, {}))
    for name, t in pair.items():
        _, _, body = get(t.address, "/statusz")
        row = json.loads(body)
        assert row["status"]["s"] == {"v": 2} and row["healthy"], name
        t.remove("s")
        _, _, body = get(t.address, "/statusz")
        row = json.loads(body)
        assert "s" not in row["status"] and "s" not in \
            row["health"]["checks"], name


# -- lifecycle ---------------------------------------------------------------

def test_discovery_files_read_across_packages(pair, tmp_path):
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    port_recs = tele.read_discovery(port_dir)
    ref_recs = ref_tele.read_discovery(ref_dir)
    assert len(port_recs) == len(ref_recs) == 1
    assert port_recs[0]["discovery_file"] == ref_recs[0][
        "discovery_file"] == f"telemetry-test-{os.getpid()}.json"
    assert sorted(port_recs[0]) == sorted(ref_recs[0])
    assert port_recs[0]["port"] == pair["port"].port
    assert port_recs[0]["run_id"] == pair["port"].journal_ref.run_id
    # each package reads the other's files
    assert tele.read_discovery(ref_dir) == ref_recs
    assert ref_tele.read_discovery(port_dir) == port_recs
    # a garbled file and one without a port are skipped by both
    (tmp_path / "port" / "telemetry-train-1.json").write_text("{tor")
    (tmp_path / "port" / "telemetry-train-2.json").write_text(
        json.dumps({"host": "127.0.0.1", "pid": 2}))
    (tmp_path / "port" / "other.json").write_text(
        json.dumps({"host": "127.0.0.1", "port": 1}))
    assert tele.read_discovery(port_dir) == port_recs == \
        ref_tele.read_discovery(port_dir)
    assert tele.read_discovery(str(tmp_path / "missing")) == []
    # close removes the file, and a second close is a no-op
    pair["port"].close()
    pair["port"].close()
    assert tele.read_discovery(port_dir) == []
    assert pair["port"].address is None


def test_bind_conflict_journals_failed_and_raises(tmp_path):
    for name, (server_cls, _, journal_cls) in PACKAGES.items():
        j = journal_cls(str(tmp_path / f"{name}.jsonl"), kind="train")
        a = server_cls(port=0, journal=j).start()
        b = server_cls(port=a.port, journal=j)
        with pytest.raises(OSError):
            b.start()
        a.close()
        j.close()
    rows = {name: [e for e in read(str(tmp_path / f"{name}.jsonl"))
                   if e["event"] == "telemetry_server"]
            for name, read in (("port", read_journal),
                               ("ref", ref_read_journal))}
    for name, ev in rows.items():
        assert [e["outcome"] for e in ev] == ["started", "failed",
                                              "stopped"], name
        assert ev[0]["port"] == ev[1]["port"] == ev[2]["port"]
        assert "Error" in ev[1]["error"]
    assert [sorted(e) for e in rows["port"]] == \
        [sorted(e) for e in rows["ref"]]


def test_telemetry_rows_pass_check_journal_strict(pair):
    rows = {}
    for name, t in pair.items():
        port = t.port
        t.journal_ref.manifest(config={"name": "t", "task": "clf"})
        t.close()
        t.journal_ref.close()
        read = read_journal if name == "port" else ref_read_journal
        rows[name] = [e for e in read(t.journal_ref.path)
                      if e["event"] == "telemetry_server"]
        assert [(e["outcome"], e["port"]) for e in rows[name]] == [
            ("started", port), ("stopped", port)]
    assert check_journal(pair["port"].journal_ref.path, strict=True) == []
    assert [sorted(e) for e in rows["port"]] == \
        [sorted(e) for e in rows["ref"]]
    assert rows["port"][0]["host"] == "127.0.0.1"
    assert rows["port"][0]["role"] == "test"


def test_outcomes_are_the_references_and_check_journals():
    assert tele.TELEMETRY_OUTCOMES == ref_tele.TELEMETRY_OUTCOMES
    assert set(tele.TELEMETRY_OUTCOMES) == TELEMETRY_SERVER_OUTCOMES
    assert tele.DISCOVERY_PREFIX == ref_tele.DISCOVERY_PREFIX


# -- what the endpoints read -------------------------------------------------

def test_flight_tail_is_the_references(tmp_path):
    rows = [{"event": "step", "step": i, "ts": float(i)} for i in range(40)]
    port = FlightRecorder(str(tmp_path / "port"), max_tail=32)
    ref = RefFlight(str(tmp_path / "ref"), max_tail=32)
    for r in rows:
        port.observe(dict(r))
        ref.observe(dict(r))
    for n in (0, 1, 5, 32, 100):
        assert port.tail(n) == ref.tail(n)
    assert [r["step"] for r in port.tail(3)] == [37, 38, 39]
    port.close()
    ref.close()


def test_statusz_serves_the_flight_tail(tmp_path):
    j = RunJournal(str(tmp_path / "j.jsonl"))
    fr = FlightRecorder(str(tmp_path / "flight"))
    fr.attach(j)
    t = TelemetryServer(journal=j, flight=fr, tail_n=2).start()
    try:
        j.write("note", note="a")
        j.step(7, loss=1.5)
        _, _, body = get(t.address, "/statusz")
        events = json.loads(body)["recent_events"]
        assert [e["event"] for e in events] == ["note", "step"]
        assert events[1]["step"] == 7
    finally:
        t.close()
        j.close()
        fr.close()


def test_manifest_row_is_the_manifest_written(tmp_path):
    j = RunJournal(str(tmp_path / "j.jsonl"))
    assert j.manifest_row() is None
    j.manifest(config={"name": "x", "lr": 0.1}, device="cpu")
    j.close()
    (row,) = [r for r in read_journal(j.path)
              if r["event"] == "run_manifest"]
    want = {k: v for k, v in row.items()
            if k not in ("event", "ts", "run_id")}
    assert j.manifest_row() == want


def test_perf_status_has_the_references_shape():
    quantiles = {"step_time_ms_p50": 4.642, "step_time_ms_p95": 10.0}
    try:
        for mod in (perfwatch, ref_perfwatch):
            mod._reset_for_tests()
            assert "step_time_ms_p50" not in mod.telemetry_status()
            mod.set_quantile_source(lambda: dict(quantiles))
            mod.note_gate({"verdict": "pass", "metric": "step_ms"})
            mod.note_digest({"top_op": "conv"})
        got, want = perfwatch.telemetry_status(), \
            ref_perfwatch.telemetry_status()
        assert sorted(got) == sorted(want)
        assert {k: v for k, v in got.items() if k != "recompiles"} == \
            {k: v for k, v in want.items() if k != "recompiles"}
        assert isinstance(got["recompiles"], int)
        # a raising source costs its keys, never the status
        perfwatch.set_quantile_source(boom)
        assert "step_time_ms_p50" not in perfwatch.telemetry_status()
    finally:
        perfwatch._reset_for_tests()
        ref_perfwatch._reset_for_tests()
