"""The port's model summary (core/summary.py), Prometheus file writer
(obs/registry.py `write_prometheus`) and train_cli's --summary,
--tensorboard-dir, --metrics-export and --telemetry-sample-every.

`model_summary`'s totals (trainable params and their MB, batch-norm
stats, total) and its row count equal the reference's for lenet5,
resnet50 and dcgan_generator at their registered input shapes (the rows
themselves are the port's names and OIHW shapes). `write_prometheus` is
checked as tests/test_observability.py checks the reference's: the
file is `to_prometheus()`, written whole, parent directories created,
by process 0 only. Then one CPU `train_cli` run with all four flags, on
a tiny config registered for the test, whose journal the reference's
tools/check_journal.py (--strict) and tools/obs_report.py read, and
one dcgan_mnist run whose rows carry the GAN clock.
"""
import os
import re
import sys

import pytest
import torch

from deep_vision_tpu.configs import get_config as ref_get_config
from deep_vision_tpu.core.summary import model_summary as ref_summary
from deep_vision_tpu.models import get_model as ref_get_model
from deep_vision_tpu.train_cli import model_input_shape
from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, ExperimentConfig
from deep_vision_tpu_torch.core.summary import model_summary
from deep_vision_tpu_torch.core.tensorboard import read_scalars
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.obs import registry as registry_mod
from deep_vision_tpu_torch.obs.journal import read_journal
from deep_vision_tpu_torch.obs.registry import Registry, get_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTALS = ("trainable params:", "batch-norm stats:", "total:")


def totals_and_rows(table):
    lines = table.splitlines()
    rules = [i for i, line in enumerate(lines) if set(line) == {"-"}]
    return ([line for line in lines if line.startswith(TOTALS)],
            rules[1] - rules[0] - 1)


@pytest.mark.parametrize("name,config", [("lenet5", "lenet5"),
                                         ("resnet50", "resnet50"),
                                         ("dcgan_generator", None)])
def test_model_summary_totals_are_the_references(name, config):
    import jax.numpy as jnp

    if config is None:
        shape, kw = (100,), {}
    else:
        cfg = ref_get_config(config)
        shape = model_input_shape(cfg)
        kw = dict(num_classes=cfg.num_classes, **cfg.model_kwargs)
    ref = ref_summary(ref_get_model(name, **kw), jnp.ones((2, *shape)))
    # one row through the port's forward: the totals do not depend on it
    port = model_summary(get_model(name, device="cpu", **kw),
                         torch.ones((1, *shape)))
    assert totals_and_rows(port) == totals_and_rows(ref)
    assert totals_and_rows(port)[1] > 0


def test_model_summary_keeps_the_mode_and_refuses_a_wrong_input():
    model = get_model("lenet5", device="cpu", train=True)
    table = model_summary(model, torch.ones((1, 32, 32, 1)))
    assert model.training
    assert table.splitlines()[2].split() == ["Conv_0.weight", "(6,", "1,",
                                             "5,", "5)", "150"]
    with pytest.raises(RuntimeError):
        model_summary(model, torch.ones((1, 32, 32, 3)))


def test_write_prometheus_is_the_text_written_whole(tmp_path):
    reg = Registry()
    reg.counter("steps_total", "steps executed").inc(5)
    reg.gauge("lr", "learning rate").set(0.1)
    h = reg.histogram("step_ms", "step wall ms")
    for v in (0.5, 5.0, 50.0, 50.0, 5000.0):
        h.observe(v)
    prom = tmp_path / "m.prom"
    assert reg.write_prometheus(str(prom))
    assert prom.read_text() == reg.to_prometheus()
    assert "step_ms_count 5" in prom.read_text()
    assert sorted(os.listdir(tmp_path)) == ["m.prom"]  # no .tmp left
    # a second write replaces the file
    reg.counter("steps_total").inc()
    assert reg.write_prometheus(str(prom))
    assert "steps_total 6" in prom.read_text()


def test_write_prometheus_creates_parents_on_process_zero_only(
        tmp_path, monkeypatch):
    reg = Registry()
    reg.counter("c").inc()
    assert reg.write_prometheus(str(tmp_path / "new" / "deeper" / "m.prom"))
    assert (tmp_path / "new" / "deeper" / "m.prom").exists()
    monkeypatch.setattr(registry_mod, "process_index", lambda: 1)
    assert not reg.write_prometheus(str(tmp_path / "other" / "m.prom"))
    assert not (tmp_path / "other").exists()


@pytest.fixture
def tiny_lenet(monkeypatch):
    cfg = ExperimentConfig(
        name="tiny_summary", task="classification", model="lenet5",
        input_shape=(32, 32, 1), num_classes=10, batch_size=4, epochs=2,
        optimizer={"name": "sgd", "learning_rate": 0.05, "momentum": 0.9},
        dataset={"kind": "mnist"})
    monkeypatch.setitem(CONFIG_REGISTRY, "tiny_summary", cfg)
    return cfg


def test_train_cli_writes_the_record_the_events_and_the_export(
        tiny_lenet, tmp_path, capsys):
    steps_before = get_registry().histogram("train_step_ms").count
    journal, tb, prom = (str(tmp_path / "j.jsonl"), str(tmp_path / "tb"),
                         str(tmp_path / "out" / "m.prom"))
    assert train_cli.main([
        "-m", "tiny_summary", "--fake-data", "--fake-batches", "3",
        "--ckpt-dir", str(tmp_path / "ck"), "--journal", journal,
        "--tensorboard-dir", tb, "--metrics-export", prom, "--summary",
        "--telemetry-sample-every", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    table = re.search(r"trainable params: ([\d,]+) \(", out).group(1)
    count = re.search(r"model lenet5: ([\d,]+) trainable params",
                      out).group(1)
    assert table == count == "61,706"
    assert "Conv_0.weight" in out and f"metrics exported to {prom}" in out
    steps = [r for r in read_journal(journal) if r["event"] == "step"]
    assert [r["step"] for r in steps] == list(range(1, 7))
    assert [r["step"] for r in steps if "sync_ms" in r] == [2, 4, 6]
    for r in steps:
        assert r["step_time_ms"] >= r["data_wait_ms"] >= 0
        assert r["dispatch_ms"] > 0 and r["examples_per_sec"] > 0
        assert r["metrics"]["loss"] == r["loss"]
    (events,) = [os.path.join(tb, f) for f in os.listdir(tb)]
    scalars = [(t, s) for _, s, t, _ in read_scalars(events)]
    assert [s for t, s in scalars if t == "train/batch_loss"] == \
        list(range(1, 7))
    assert [s for t, s in scalars if t == "train/epoch_loss"] == [0, 1]
    assert [s for t, s in scalars if t == "val/epoch_loss"] == [0, 1]
    assert ("train/data_wait_ms", 6) in scalars
    sys.path.insert(0, ROOT)
    from tools.check_journal import check_journal
    from tools.obs_report import render, summarize_run

    assert check_journal(journal, strict=True) == []
    report = summarize_run(read_journal(journal))
    assert report["steps"] == 6 and report["recompiles"] >= 0
    assert {"step_time_ms", "data_wait_ms", "sync_ms",
            "examples_per_sec"} <= set(report)
    assert report["sync_ms"]["n"] == 3 and "step_time_ms" in render(report)
    text = open(prom).read()
    assert f"train_step_ms_count {steps_before + 6}" in text
    assert "# TYPE train_data_starved_steps_total counter" in text
    assert "# TYPE jit_recompiles_total gauge" in text


def test_gan_cli_rows_carry_the_clock(tmp_path, capsys):
    journal, prom = str(tmp_path / "g.jsonl"), str(tmp_path / "g.prom")
    assert train_cli.main([
        "-m", "dcgan_mnist", "--fake-data", "--fake-batches", "2",
        "--batch-size", "2", "--epochs", "1", "--ckpt-dir",
        str(tmp_path / "ck"), "--journal", journal, "--metrics-export",
        prom, "--summary", "--telemetry-sample-every", "2",
        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("trainable params: ") == 2  # G's and D's tables
    assert "-- G --" in out and "-- D --" in out
    steps = [r for r in read_journal(journal) if r["event"] == "step"]
    assert [r["step"] for r in steps] == [1, 2]
    assert [("sync_ms" in r, r["epoch"], r["examples"]) for r in steps] == [
        (False, 0, 2), (True, 0, 2)]
    assert all(r["step_time_ms"] >= r["data_wait_ms"] for r in steps)
    assert "# TYPE gan_steps_total counter" in open(prom).read()
