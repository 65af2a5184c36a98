"""`python -m deep_vision_tpu_torch.train_cli` with its black box:
`--trace`, `--flight-dir`, `DVT_LOCKSMITH=1` and the requeue exit code,
in process on the CPU.

A small classifier config (lenet5's, batch 8) on fake data, and
dcgan_mnist through `gan_main`: a SIGTERM raised after the first step
makes `main` return 75 (REQUEUE_EXIT_CODE, as the reference's
train_cli), journal a `preempt_checkpoint` with `saved` true and leave
one valid `preempt` flight bundle; a clean run returns 0 and leaves no
bundle. The trace parses with one `train/step` span a journaled step
(`gan/step` for the GAN), and the journal passes
`check_journal --strict`. The configs are registered for one test each
(monkeypatch.setitem), so the registry checks of the other CLI tests
stay clean.
"""
import dataclasses
import json
import os
import signal
import sys

import pytest
import torch

from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, get_config
from deep_vision_tpu_torch.obs import flight, locksmith, trace
from deep_vision_tpu_torch.obs.journal import read_journal
from deep_vision_tpu_torch.train import trainer as trainer_mod
from deep_vision_tpu_torch.train import gan as gan_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    flight.clear_requeue()
    locksmith.disarm()


@pytest.fixture
def tiny(monkeypatch):
    cfg = dataclasses.replace(get_config("lenet5"), name="tiny_obs_cli",
                              batch_size=8, epochs=1)
    monkeypatch.setitem(CONFIG_REGISTRY, "tiny_obs_cli", cfg)
    return "tiny_obs_cli"


def sigterm_after_first(monkeypatch, cls):
    """`cls.train_step` sends this process SIGTERM after its first
    call."""
    step = cls.train_step
    calls = []

    def signalled(self, *a, **kw):
        out = step(self, *a, **kw)
        calls.append(1)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(cls, "train_step", signalled)
    return calls


def run(tmp_path, name, *extra):
    ck, jn = str(tmp_path / "ck"), str(tmp_path / "run.jsonl")
    tr, fl = str(tmp_path / "run.trace.json"), str(tmp_path / "flight")
    rc = train_cli.main(["-m", name, "--fake-data", "--fake-batches", "3",
                         "--ckpt-dir", ck, "--journal", jn, "--trace", tr,
                         "--flight-dir", fl, "--device", "cpu", *extra])
    from tools.check_journal import check_journal, check_trace

    assert check_journal(jn, strict=True) == []
    assert check_trace(tr) == []
    assert trace.get_tracer() is None and flight.get_flight() is None
    spans = [e for e in json.load(open(tr))["traceEvents"]
             if e["ph"] == "X"]
    return rc, read_journal(jn), spans, flight.find_bundles(fl)


def test_sigterm_returns_75_with_one_bundle(tmp_path, monkeypatch, tiny):
    calls = sigterm_after_first(monkeypatch, trainer_mod.Trainer)
    rc, rows, spans, bundles = run(tmp_path, tiny)
    assert rc == flight.REQUEUE_EXIT_CODE == 75 and len(calls) == 1
    (pre,) = [r for r in rows if r["event"] == "preempt_checkpoint"]
    assert pre["saved"] is True and pre["step"] == 1
    assert len(bundles) == 1 and bundles[0].endswith("-preempt")
    assert flight.validate_bundle(bundles[0]) == []
    manifest = json.load(open(os.path.join(bundles[0], "MANIFEST.json")))
    assert manifest["run_id"] == rows[0]["run_id"]
    assert any(r["event"] == "flight_dump" and r["reason"] == "preempt"
               for r in rows)
    steps = [r for r in rows if r["event"] == "step"]
    assert sum(e["name"] == "train/step" for e in spans) == len(steps) == 1
    assert rows[-1]["event"] == "exit"


def test_clean_run_returns_0_without_a_bundle(tmp_path, monkeypatch, tiny):
    monkeypatch.setenv("DVT_LOCKSMITH", "1")
    rc, rows, spans, bundles = run(tmp_path, tiny)
    assert rc == 0 and bundles == []
    assert locksmith.get_sanitizer() is None  # the run disarmed its own
    steps = [r for r in rows if r["event"] == "step"]
    assert sum(e["name"] == "train/step" for e in spans) == len(steps) == 3
    names = {e["name"] for e in spans}
    assert {"train/epoch", "eval", "checkpoint/save"} <= names
    assert not any(r["event"] == "lock_order_violation" for r in rows)
    assert any(r.get("trace_path") for r in rows)


@pytest.mark.parametrize("signalled", [True, False])
def test_gan_main_exit_codes(tmp_path, monkeypatch, signalled):
    if signalled:
        sigterm_after_first(monkeypatch, gan_mod.DcganTrainer)
    rc, rows, spans, bundles = run(tmp_path, "dcgan_mnist", "--batch-size",
                                   "8", "--fake-batches", "2", "--epochs",
                                   "1")
    steps = [r for r in rows if r["event"] == "step"]
    assert sum(e["name"] == "gan/step" for e in spans) == len(steps)
    pre = [r for r in rows if r["event"] == "preempt_checkpoint"]
    if signalled:
        assert rc == 75 and len(steps) == 1
        assert len(pre) == 1 and pre[0]["saved"] is True
        assert len(bundles) == 1 and bundles[0].endswith("-preempt")
        assert flight.validate_bundle(bundles[0]) == []
    else:
        assert rc == 0 and len(steps) == 2 and pre == [] and bundles == []
    assert "checkpoint/save" in {e["name"] for e in spans}
