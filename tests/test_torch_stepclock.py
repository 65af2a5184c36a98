"""The port's StepClock (obs/stepclock.py) against the JAX package's.

One scripted sequence of steps (the same batch sizes, fence cadence,
deferred and automatic commits, and a seeded sleep-driven data
iterator) runs through each package's clock, registry and journal: the
same steps are sampled, each step's `fields()` has the same keys, the
journal rows the same keys and step numbers, and the registries the
same Prometheus families and `# TYPE` lines. Timing values are wall
clock and are not compared. Then the reference's own StepClock tests
(tests/test_observability.py) on the port, a CPU `Trainer.fit` whose
step rows carry the fields, and the port's compiles: core/build.py's
compiler runs, which a step row reports as `compile_ms` and a sampled
one as `recompiles`.
"""
import time

import numpy as np
import pytest
import torch

from deep_vision_tpu.obs import stepclock as ref_sc
from deep_vision_tpu.obs.journal import RunJournal as RefJournal
from deep_vision_tpu.obs.journal import read_journal as ref_read
from deep_vision_tpu.obs.registry import Registry as RefRegistry
from deep_vision_tpu_torch.core import build
from deep_vision_tpu_torch.obs import stepclock as port_sc
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry

#: the scripted steps: batch sizes, the fence cadence, and the steps
#: (0-based) that commit automatically at the with-block's end
BATCHES = (16, 8, 16, 4, 16, 16, 8, 16, 2, 16, 16)
SAMPLE_EVERY = 3
AUTO = (2, 5, 9)
#: journal keys every row has, whatever its event
ROW_BASE = {"event", "ts", "run_id"}


@pytest.fixture(scope="module")
def jax_fence():
    """A finished JAX array for the reference's fence, made before any
    clock is built: no compile happens inside the scripted steps."""
    import jax.numpy as jnp

    x = jnp.ones((4,))
    x.block_until_ready()
    return x


def seeded_data(seed=0):
    rs = np.random.RandomState(seed)
    for n in BATCHES:
        time.sleep(rs.uniform(0.001, 0.004))
        yield n


def scripted(sc, registry, journal, fence):
    """The sequence through module `sc`'s StepClock; -> (clock, each
    step's fields() keys)."""
    clock = sc.StepClock(registry=registry, journal=journal, name="t",
                         sample_every=SAMPLE_EVERY)
    keys = []
    for i, n in enumerate(clock.iter_data(seeded_data())):
        auto = i in AUTO
        with clock.step(batch_size=n, auto_commit=auto) as rec:
            rec.fence_on(fence)
        if not auto:
            rec.commit(step=100 + i, metrics={"loss": 0.5, "lr": 0.1},
                       extra={"epoch": 0, "examples": n})
        keys.append(sorted(rec.fields()))
    return clock, keys


def type_lines(text):
    return [line for line in text.splitlines() if line.startswith("# TYPE")]


def families(text):
    return sorted({line.split()[2] for line in type_lines(text)})


def test_a_scripted_sequence_agrees_with_the_reference(tmp_path, jax_fence):
    got = {}
    for impl, sc, reg, journal_cls, read, fence in (
            ("ref", ref_sc, RefRegistry, RefJournal, ref_read, jax_fence),
            ("port", port_sc, Registry, RunJournal, read_journal,
             torch.ones(4))):
        path = str(tmp_path / f"{impl}.jsonl")
        journal = journal_cls(path)
        registry = reg()
        clock, keys = scripted(sc, registry, journal, fence)
        journal.close()
        steps = [r for r in read(path) if r["event"] == "step"]
        text = registry.to_prometheus()
        got[impl] = {
            "seen": clock.steps_seen, "sampled": clock.sync_samples,
            "keys": keys,
            "rows": [(r["step"], sorted(set(r) - ROW_BASE)) for r in steps],
            "sync": [r["step"] for r in steps if "sync_ms" in r],
            "families": families(text), "types": type_lines(text)}
        for r in steps:
            assert r["step_time_ms"] >= r["data_wait_ms"] >= 0
            assert r["examples_per_sec"] > 0
    assert got["port"] == got["ref"]
    assert got["port"]["sampled"] == len(BATCHES) // SAMPLE_EVERY
    assert [s for s, _ in got["port"]["rows"]] == [
        i + 1 if i in AUTO else 100 + i for i in range(len(BATCHES))]


def test_the_registry_families_are_the_references(jax_fence):
    """Every family a clock registers, by name and kind, for each clock
    name the Trainer and the GAN trainers use."""
    for name in ("train", "gan"):
        texts = []
        for sc, reg in ((ref_sc, RefRegistry), (port_sc, Registry)):
            registry = reg()
            sc.StepClock(registry=registry, name=name)
            texts.append(registry.to_prometheus())
        assert type_lines(texts[1]) == type_lines(texts[0])
        assert f"{name}_data_starved_steps_total" in families(texts[1])


def test_stepclock_sampling_cadence(tmp_path):
    path = str(tmp_path / "clock.jsonl")
    j = RunJournal(path)
    clock = port_sc.StepClock(registry=Registry(), journal=j, name="t",
                              sample_every=4)
    for i in range(8):
        with clock.step(batch_size=16) as rec:
            rec.fence_on(torch.ones(()) * i)
    j.close()
    assert clock.steps_seen == 8
    assert clock.sync_samples == 2  # steps 4 and 8 only
    steps = [e for e in read_journal(path) if e["event"] == "step"]
    assert len(steps) == 8
    sampled = [e["step"] for e in steps if "sync_ms" in e]
    assert sampled == [4, 8]
    for e in steps:
        assert e["step_time_ms"] >= e["data_wait_ms"]
        assert e["examples_per_sec"] > 0


def test_stepclock_iter_data_times_waits():
    clock = port_sc.StepClock(registry=Registry(), name="t2",
                              sample_every=100)

    def slow_data():
        for i in range(3):
            time.sleep(0.02)
            yield i

    waits = []
    for _ in clock.iter_data(slow_data()):
        with clock.step(batch_size=1) as rec:
            pass
        waits.append(rec.data_wait_ms)
    assert len(waits) == 3
    assert all(w >= 15.0 for w in waits), waits


def test_the_cpu_fence_and_memory_read_nothing_of_a_card():
    """A CPU step's fence synchronizes nothing and its memory fields are
    absent, as the reference's on a backend without memory stats."""
    assert port_sc.hbm_stats(torch.device("cpu")) == (None, None)
    assert ref_sc.hbm_stats() == (None, None)
    clock = port_sc.StepClock(registry=Registry(), name="t3",
                              sample_every=1)
    with clock.step(batch_size=2) as rec:
        rec.fence_on({"loss": torch.zeros(()), "n": [torch.ones(2)]})
    assert rec.device == torch.device("cpu")
    assert rec.sync_ms is not None and rec.hbm_bytes is None
    assert sorted(rec.fields()) == sorted(
        ["step_time_ms", "data_wait_ms", "dispatch_ms", "examples_per_sec",
         "sync_ms", "recompiles"])


def test_recompile_count_is_the_builds_and_compile_ms_their_seconds(
        tmp_path):
    """recompile_count() is build.build_count(); a compiler run inside a
    step (a g++ library through core/build.py) is that row's
    compile_ms and moves the sampled row's `recompiles`."""
    assert port_sc.recompile_count() == build.build_count()
    src = tmp_path / "probe.cc"
    src.write_text('extern "C" int probe() { return 21; }\n')
    path = str(tmp_path / "j.jsonl")
    journal = RunJournal(path)
    clock = port_sc.StepClock(registry=Registry(), journal=journal,
                              name="t4", sample_every=2)
    before, seconds = build.build_count(), build.compile_seconds()
    for i in range(2):
        with clock.step(batch_size=1) as rec:
            if i == 0:
                took = build.compile_all({"probe": (
                    ["g++", "-shared", "-fPIC"], [str(src)],
                    tmp_path / "probe.so")})
            rec.fence_on(torch.zeros(()))
    journal.close()
    rows = [r for r in read_journal(path) if r["event"] == "step"]
    assert build.build_count() == before + 1 == port_sc.recompile_count()
    assert build.compile_seconds() == pytest.approx(seconds + took["probe"])
    assert rows[0]["compile_ms"] == pytest.approx(took["probe"] * 1e3,
                                                  abs=1e-3)
    assert "compile_ms" not in rows[1]
    assert "recompiles" not in rows[0]
    assert rows[1]["recompiles"] == build.build_count()


def test_a_cpu_fit_writes_the_fields_with_the_schedules_lr(tmp_path):
    from deep_vision_tpu_torch.losses import classification_loss_fn
    from deep_vision_tpu_torch.models import get_model
    from deep_vision_tpu_torch.train import Trainer, build_optimizer
    from deep_vision_tpu_torch.train.optimizers import make_schedule

    schedule = make_schedule("cosine", 0.05, warmup_steps=2, total_steps=6)
    rs = np.random.RandomState(0)
    batches = [{"image": rs.rand(4, 32, 32, 1).astype(np.float32),
                "label": rs.randint(0, 10, 4)} for _ in range(3)]
    path = str(tmp_path / "fit.jsonl")
    journal = RunJournal(path)
    tr = Trainer(get_model("lenet5", device="cpu", train=True),
                 build_optimizer("sgd", schedule, momentum=0.9),
                 classification_loss_fn, torch.zeros(2, 32, 32, 1),
                 device="cpu", journal=journal, registry=Registry(),
                 telemetry_sample_every=2)
    tr.fit(lambda: iter(batches), epochs=2)
    journal.close()
    rows = [r for r in read_journal(path) if r["event"] == "step"]
    assert [r["step"] for r in rows] == list(range(1, 7))
    for i, r in enumerate(rows):
        assert r["metrics"]["lr"] == r["lr"] == schedule(r["step"] - 1)
        assert r["metrics"]["loss"] == r["loss"]
        assert {"epoch", "examples", "grad_norm", "skipped"} <= set(r)
        assert r["step_time_ms"] >= r["data_wait_ms"] >= 0
        assert r["dispatch_ms"] > 0 and r["examples_per_sec"] > 0
        assert ("sync_ms" in r) == ("recompiles" in r) == (i % 2 == 1)
        assert "hbm_bytes" not in r
    assert tr.clock.steps_seen == 6 and tr.clock.sync_samples == 3
