"""The spans of the port's feed and trainers (data/pipeline.py,
train/trainer.py, train/gan.py) under obs/trace.py.

The feed: the port's DataLoader and the JAX package's, on the same
dataset, give the same multiset of `data/fetch`, `data/augment_batch`
and `data/collate` spans (names and args; the queue depth each fetch
saw masked): one fetch a batch and none at the end-of-epoch sentinel.
The Trainer: a tiny port Trainer's fit gives `train/epoch` enclosing
its two `train/step` spans (each with its `step`), `eval` and
`checkpoint/save`, as the reference's
tests/test_health_trace.py::test_trainer_trace_has_nested_step_eval_spans
asserts of its own; a resume gives `checkpoint/restore`. A SIGTERM in
fit asks for the requeue exit code. The GAN trainers' spans nest as the
reference's: `gan/step` around CycleGAN's `gan/g_step`, `gan/pool` and
`gan/d_step`.
"""
import json
import os
import signal
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from deep_vision_tpu.data.pipeline import DataLoader as RefDataLoader
from deep_vision_tpu.obs import trace as ref_trace
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.data.pipeline import DataLoader
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.obs import flight, trace
from deep_vision_tpu_torch.train import Trainer, build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _no_tracer():
    yield
    trace.set_tracer(None)
    ref_trace.set_tracer(None)
    flight.clear_requeue()


def traced(mod, path, fn):
    """Run fn under an installed tracer of `mod`; the complete events."""
    t = mod.Tracer(path)
    mod.set_tracer(t)
    try:
        fn()
    finally:
        mod.set_tracer(None)
        t.close()
    return [e for e in json.load(open(path))["traceEvents"]
            if e["ph"] == "X"]


def span_multiset(spans):
    out = Counter()
    for e in spans:
        args = {k: v for k, v in e.get("args", {}).items()
                if k != "prefetch_depth"}
        out[(e["name"], json.dumps(args, sort_keys=True))] += 1
    return out


@pytest.mark.parametrize("n,batch,drop", [(10, 4, False), (12, 4, True),
                                          (9, 3, True)])
def test_loader_spans_match_the_reference(tmp_path, n, batch, drop):
    rng = np.random.RandomState(n)
    ds = [{"x": rng.rand(3).astype(np.float32), "y": np.int32(i)}
          for i in range(n)]
    got, want = [], []
    port = traced(trace, str(tmp_path / "port.json"), lambda: got.extend(
        DataLoader(ds, batch_size=batch, num_workers=2, prefetch=2,
                   drop_remainder=drop, name="feed")))
    ref = traced(ref_trace, str(tmp_path / "ref.json"), lambda: want.extend(
        RefDataLoader(ds, batch_size=batch, num_workers=2, prefetch=2,
                      drop_remainder=drop, name="feed")))
    assert len(got) == len(want)
    assert span_multiset(port) == span_multiset(ref)
    names = [e["name"] for e in port]
    assert names.count("data/fetch") == len(got)  # not the sentinel
    assert names.count("data/augment_batch") == len(got)
    fetch = next(e for e in port if e["name"] == "data/fetch")
    assert fetch["args"]["loader"] == "feed"
    assert fetch["args"]["prefetch_depth"] >= 0


def tiny_trainer(tmp_path, **kw):
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(48, 4))
    return Trainer(model, build_optimizer("sgd", 0.1),
                   classification_loss_fn, torch.zeros(1, 4, 4, 3),
                   device="cpu",
                   checkpoint_manager=CheckpointManager(
                       str(tmp_path / "ck")), **kw)


def batches(n=2, rows=8):
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(rows, 4, 4, 3).astype(np.float32),
             "label": rng.randint(0, 4, rows).astype(np.int32)}
            for _ in range(n)]


def test_trainer_spans_nest(tmp_path):
    data = batches()

    def run():
        t = tiny_trainer(tmp_path)
        t.fit(lambda: data, lambda: data, epochs=1,
              handle_preemption=False)
        t.close()

    spans = traced(trace, str(tmp_path / "run.trace.json"), run)
    names = {e["name"] for e in spans}
    assert {"train/epoch", "train/step", "eval",
            "checkpoint/save"} <= names
    epoch = next(e for e in spans if e["name"] == "train/epoch")
    steps = [e for e in spans if e["name"] == "train/step"]
    assert len(steps) == 2
    for s in steps:
        assert epoch["ts"] <= s["ts"]
        assert s["ts"] + s["dur"] <= epoch["ts"] + epoch["dur"] + 1
        assert s["args"]["epoch"] == 0
    assert [s["args"]["step"] for s in steps] == [1, 2]
    save = next(e for e in spans if e["name"] == "checkpoint/save")
    assert save["args"] == {"epoch": 0, "step": 2}
    from tools.check_journal import check_trace

    assert check_trace(str(tmp_path / "run.trace.json")) == []

    def resume():
        t = tiny_trainer(tmp_path)
        assert t.resume() == 1
        t.close()

    spans = traced(trace, str(tmp_path / "resume.trace.json"), resume)
    (restore,) = [e for e in spans if e["name"] == "checkpoint/restore"]
    assert restore["args"] == {"step": -1}


def test_sigterm_in_fit_requests_the_requeue(tmp_path):
    data = batches(3)
    t = tiny_trainer(tmp_path)
    step = t.train_step
    calls = []

    def signalled(batch):
        out = step(batch)
        calls.append(1)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    t.train_step = signalled
    assert not flight.requeue_requested()
    t.fit(lambda: data, epochs=1)
    t.close()
    assert t.preempted and len(calls) == 1
    assert flight.requeue_requested()


def test_gan_spans(tmp_path):
    from deep_vision_tpu_torch.models import cyclegan as port_cyc
    from deep_vision_tpu_torch.train.gan import CycleGanTrainer

    def tx_fn():
        return build_optimizer("adam", 2e-4, b1=0.5)

    trainer = CycleGanTrainer(
        port_cyc.CycleGanGenerator(n_blocks=1, base=8),
        port_cyc.CycleGanGenerator(n_blocks=1, base=8),
        port_cyc.PatchGanDiscriminator(base=8),
        port_cyc.PatchGanDiscriminator(base=8), tx_fn, tx_fn,
        image_shape=(32, 32, 3), device="cpu")
    ck = CheckpointManager(str(tmp_path / "gan"))
    real = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)

    def run():
        trainer.train_step(real[:1], real[1:])
        trainer.save(ck, 0)
        ck.wait()
        trainer.restore(ck)

    spans = traced(trace, str(tmp_path / "gan.json"), run)
    names = [e["name"] for e in spans]
    assert names == ["gan/g_step", "gan/pool", "gan/d_step", "gan/step",
                     "checkpoint/save", "checkpoint/restore"]
    outer = spans[3]
    for inner in spans[:3]:
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert spans[4]["args"] == {"epoch": 0, "step": 1}
