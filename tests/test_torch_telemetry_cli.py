"""`train_cli --telemetry-port` / `DVT_TELEMETRY` and the port's
`tools/obs_poll.py`, in process on the CPU.

A small classifier config (lenet5's, batch 8) on fake data: while the
run trains its discovery file is under the checkpoint dir, /statusz
follows the steps, /healthz carries the `train` check, and the port's
`obs_poll --once` exits 0 with lines equal to the reference
tools/obs_poll.py's on the same /statusz and /healthz bodies; at exit
the file is gone and the journal holds `started` and `stopped` with the
bound port. `DVT_TELEMETRY=0` binds like the flag; a knob that does not
parse and a taken port each warn and the run trains. A stale discovery
file renders GONE in both tools. dcgan_mnist through `gan_main`
registers the `train` health source and no status source, as the
reference's GAN branch. (And the skip_step policy trains a model
without buffers, which raised.) The configs are registered for one test each
(monkeypatch.setitem), so the registry checks of the other CLI tests
stay clean.
"""
import dataclasses
import json
import os
import socket
import sys
import urllib.error
import urllib.request

import pytest
import torch

from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, get_config
from deep_vision_tpu_torch.obs import TelemetryServer, perfwatch
from deep_vision_tpu_torch.obs.journal import read_journal
from deep_vision_tpu_torch.obs.telemetry import read_discovery
from deep_vision_tpu_torch.tools import obs_poll
from deep_vision_tpu_torch.train import gan as gan_mod
from deep_vision_tpu_torch.train import trainer as trainer_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import obs_poll as ref_poll  # noqa: E402
from tools.check_journal import check_journal  # noqa: E402


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    perfwatch._reset_for_tests()


@pytest.fixture
def tiny(monkeypatch):
    cfg = dataclasses.replace(get_config("lenet5"), name="tiny_tele_cli",
                              batch_size=8, epochs=1)
    monkeypatch.setitem(CONFIG_REGISTRY, "tiny_tele_cli", cfg)
    return "tiny_tele_cli"


def get_json(address, path):
    try:
        with urllib.request.urlopen(f"http://{address}{path}",
                                    timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run(tmp_path, name, *extra):
    ck, jn = str(tmp_path / "ck"), str(tmp_path / "run.jsonl")
    rc = train_cli.main(["-m", name, "--fake-data", "--fake-batches", "3",
                         "--ckpt-dir", ck, "--journal", jn, "--device",
                         "cpu", *extra])
    rows = read_journal(jn)
    assert check_journal(jn, strict=True) == []
    return rc, ck, [r for r in rows if r["event"] == "telemetry_server"]


def scrape_each_step(monkeypatch, cls, method, ck, seen):
    """`cls.<method>` scrapes the run's own endpoint after each call:
    the discovery file, /statusz, /healthz, and one `obs_poll --once`
    of the port's tool beside the reference tool's line on the same
    bodies."""
    step = getattr(cls, method)

    def scraped(self, *a, **kw):
        out = step(self, *a, **kw)
        (rec,) = read_discovery(ck)
        address = f"{rec['host']}:{rec['port']}"
        code, status = get_json(address, "/statusz")
        hcode, health = get_json(address, "/healthz")
        seen.append((rec, code, status, hcode, health))
        if len(seen) == 1:
            seen.append(obs_poll.main(["--run-dir", ck, "--once"]))
            _, alertz = get_json(address, "/alertz")
            seen.append((obs_poll.format_line(rec, status, True, health,
                                              alertz),
                         ref_poll.format_line(rec, status, True, health,
                                              alertz)))
        return out

    monkeypatch.setattr(cls, method, scraped)


def test_the_cli_serves_while_it_trains_and_cleans_up(tiny, tmp_path,
                                                     monkeypatch, capsys):
    ck = str(tmp_path / "ck")
    seen = []
    scrape_each_step(monkeypatch, trainer_mod.Trainer,
                     "_single_step_and_log", ck, seen)
    rc, _, rows = run(tmp_path, tiny, "--telemetry-port", "0",
                      "--health-policy", "warn")
    assert rc == 0
    out = capsys.readouterr().out
    first, poll_rc, (line, ref_line) = seen[:3]
    scrapes = [first] + seen[3:]
    assert len(scrapes) == 3  # one a step
    rec = first[0]
    assert rec["discovery_file"] == f"telemetry-train-{os.getpid()}.json"
    assert f"telemetry: http://127.0.0.1:{rec['port']}/statusz" in out
    assert poll_rc == 0 and line == ref_line and line in out
    assert line.startswith("train") and " OK " in line
    assert "step 1" in line and "p50 " in line
    steps = [s[2]["status"]["train"]["step"] for s in scrapes]
    assert steps == [1, 2, 3]
    for _, code, status, hcode, health in scrapes:
        assert code == hcode == 200 and status["healthy"]
        assert sorted(health["checks"]) == ["train"]
        assert sorted(status["status"]) == ["perf", "train"]
        assert status["manifest"]["config"]["name"] == tiny
    assert "step_time_ms_p50" in scrapes[-1][2]["status"]["perf"]
    assert read_discovery(ck) == []
    assert [(r["outcome"], r["port"], r["role"]) for r in rows] == [
        ("started", rec["port"], "train"), ("stopped", rec["port"],
                                            "train")]


@pytest.mark.parametrize("value", ["0", "garbage"])
def test_the_knob_binds_or_warns(tiny, tmp_path, monkeypatch, capsys,
                                 value):
    monkeypatch.setenv("DVT_TELEMETRY", value)
    rc, ck, rows = run(tmp_path, tiny)
    assert rc == 0
    err = capsys.readouterr().err
    if value == "garbage":
        assert "DVT_TELEMETRY='garbage' is not an integer" in err
        assert "telemetry disabled" in err and rows == []
    else:
        assert [r["outcome"] for r in rows] == ["started", "stopped"]
        assert rows[0]["port"] > 0
    assert read_discovery(ck) == []


def test_a_taken_port_warns_and_trains(tiny, tmp_path, capsys):
    taken = TelemetryServer(port=0).start()
    port = taken.port
    try:
        rc, ck, rows = run(tmp_path, tiny, "--telemetry-port", str(port))
    finally:
        taken.close()
    assert rc == 0
    err = capsys.readouterr().err
    assert f"telemetry server failed to bind port {port}" in err
    assert "continuing without live endpoints" in err
    assert [(r["outcome"], r["port"]) for r in rows] == [("failed", port)]
    assert read_discovery(ck) == []


def test_skip_step_trains_a_model_without_buffers(tiny, tmp_path):
    """lenet5 has no BatchNorm: the skip_step policy has no buffers to
    keep (torch._foreach_copy_ of an empty list raised)."""
    rc, _, _ = run(tmp_path, tiny, "--health-policy", "skip_step")
    steps = [r for r in read_journal(str(tmp_path / "run.jsonl"))
             if r["event"] == "step"]
    assert rc == 0 and [r["skipped"] for r in steps] == [False] * 3


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_stale_discovery_file_is_gone_in_both_tools(tmp_path, capsys):
    (tmp_path / "telemetry-train-4242.json").write_text(json.dumps(
        {"host": "127.0.0.1", "port": free_port(), "pid": 4242,
         "role": "train", "run_id": "r", "ts": 0.0}))
    assert obs_poll.main(["--run-dir", str(tmp_path), "--once",
                          "--timeout", "2"]) == 1
    (line,) = capsys.readouterr().out.splitlines()
    assert line.endswith(" GONE")
    assert ref_poll.poll_once(str(tmp_path), timeout=2.0) == (
        [line], False, False)
    assert obs_poll.main(["--run-dir", str(tmp_path / "none")]) == 1
    assert capsys.readouterr().out.startswith(
        "no telemetry discovery files under")


def test_strict_alerts_exit_with_a_firing_rule(tmp_path, capsys):
    class Paging:
        def active(self):
            return [{"rule": "slo_burn", "severity": "ticket"}]

        def alertz(self):
            return {"now": 1.0, "active": self.active(), "history": [],
                    "rules": []}

    t = TelemetryServer(port=0, role="serve",
                        discovery_dir=str(tmp_path)).start()
    try:
        t.set_alerts(Paging())
        assert obs_poll.main(["--run-dir", str(tmp_path)]) == 0
        assert obs_poll.main(["--run-dir", str(tmp_path),
                              "--strict-alerts"]) == 1
    finally:
        t.close()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] and lines[0].endswith("ALERTS slo_burn")


def test_the_gan_branch_registers_its_health_source_only(tmp_path,
                                                         monkeypatch):
    ck = str(tmp_path / "ck")
    seen = []
    scrape_each_step(monkeypatch, gan_mod.DcganTrainer, "train_step", ck,
                     seen)
    rc, _, rows = run(tmp_path, "dcgan_mnist", "--batch-size", "8",
                      "--fake-batches", "2", "--epochs", "1",
                      "--telemetry-port", "0", "--health-policy", "warn")
    assert rc == 0
    scrapes = [seen[0]] + seen[3:]
    assert len(scrapes) == 2
    for _, code, status, hcode, health in scrapes:
        assert code == hcode == 200
        assert sorted(health["checks"]) == ["train"]
        assert health["checks"]["train"]["monitor"] == "train"
        assert status["status"] == {}
    assert read_discovery(ck) == []
    assert [r["outcome"] for r in rows] == ["started", "stopped"]
