"""Port parity: core/checkpoint.py, resilience/faults.py, data/native.py's
crc32c and obs/journal.py against the JAX package, on the CPU.

Every comparison here is exact: the sidecar's bytes against the
reference's `_write_sidecar_once` for the same host state, each side
reading the other's sidecar, the crc32c against `google_crc32c.value`,
the fault injector's firing sequences against the reference injector's
for the same spec and seed, and restored tensors against the saved ones
bit for bit. The checkpoint cases mirror tests/test_resilience.py's
(rot, legacy sidecar, half-written sidecar, retried I/O error, corrupt
fault, quarantine with fallback, missing sidecar among siblings,
explicit corrupt step, nothing valid, GC under max_to_keep, SIGKILL
mid-save, and SIGKILL mid-save in a CLI run).
"""
import json
import os
import signal
import subprocess
import sys

import google_crc32c
import numpy as np
import pytest
import torch

from deep_vision_tpu.resilience import faults as ref_faults
from deep_vision_tpu_torch.core.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
)
from deep_vision_tpu_torch.core.train_state import create_train_state
from deep_vision_tpu_torch.data.native import crc32c
from deep_vision_tpu_torch.obs.journal import RunJournal, read_journal
from deep_vision_tpu_torch.obs.registry import Registry
from deep_vision_tpu_torch.resilience import (
    FaultInjected,
    FaultInjector,
    FaultSpecError,
    RetryPolicy,
    faults,
)
from deep_vision_tpu_torch.train import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a tiny classification config and model for CLI runs in subprocesses
TINY_SETUP = """
from deep_vision_tpu_torch.configs import ExperimentConfig, register_config
from deep_vision_tpu_torch.models import MODEL_REGISTRY, register_model
from deep_vision_tpu_torch.models import resnet as _resnet


def _tiny(num_classes=10, dtype=None, stem="s2d", **_):
    return _resnet.ResNet(stage_sizes=(1, 1, 1, 1), width=8,
                          num_classes=num_classes, stem=stem, dtype=dtype)


if "resnet_tiny" not in MODEL_REGISTRY:
    register_model("resnet_tiny", init=_resnet.reset_parameters)(_tiny)
register_config(ExperimentConfig(
    name="tiny_s2d", task="classification", model="resnet_tiny",
    model_kwargs={"stem": "s2d"}, input_shape=(32, 32, 3), num_classes=10,
    batch_size=8, epochs=2,
    optimizer={"name": "sgd", "learning_rate": 0.05, "momentum": 0.9,
               "weight_decay": 1e-4},
    plateau={"factor": 0.1, "mode": "max"}, dataset={"kind": "imagenet"},
    train_resize=40, eval_crop=32))
"""


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.install(None)
    ref_faults.install(None)
    for mod in (faults, ref_faults):
        os.environ.pop(mod.ENV_SPEC, None)
        os.environ.pop(mod.ENV_SEED, None)


class _Journal:
    def __init__(self):
        self.rows = []

    def write(self, event, **fields):
        self.rows.append({"event": event, **fields})


def _tree(v):
    return {"w": torch.full((4,), float(v)), "b": torch.full((2,),
                                                             -float(v))}


def _manager(tmp_path, journal=None, **kw):
    return CheckpointManager(str(tmp_path / "ckpt"), journal=journal, **kw)


HOST_STATES = [
    {"epoch": 3, "lr": 0.1},
    {"epoch": 0, "plateau": {"best": 0.25, "num_bad": 1, "scale": 0.1},
     "train_logger": {"history": {"loss": [[0, 2.5], [1, 1.25]]}},
     "val_logger": {"history": {}}},
    {"data_state": {"epoch": 2, "batches": 5, "cursor": None,
                    "fingerprint": "abc", "note": "é ∑ ☃"},
     "values": [1e-30, -0.0, 3.141592653589793, None, True]},
]


# -- crc32c and the sidecar format -------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 64, 4097])
def test_crc32c_equals_google_crc32c(n):
    data = np.random.RandomState(n).bytes(n)
    assert crc32c(data) == google_crc32c.value(data)


@pytest.mark.parametrize("host_state", HOST_STATES)
def test_sidecar_bytes_equal_the_references(tmp_path, host_state):
    from deep_vision_tpu.core.checkpoint import CheckpointManager as Ref

    port = _manager(tmp_path)
    ref = Ref(str(tmp_path / "ref"))
    port._write_sidecar_once(5, host_state)
    ref._write_sidecar_once(5, host_state)
    got = open(port._sidecar_path(5), "rb").read()
    want = open(ref._sidecar_path(5), "rb").read()
    assert got == want
    # each side reads the other's file
    os.replace(ref._sidecar_path(5), ref._sidecar_path(6))
    os.replace(port._sidecar_path(5), ref._sidecar_path(5))
    os.replace(ref._sidecar_path(6), port._sidecar_path(5))
    assert ref._read_sidecar(5) == (host_state, None)
    assert port._read_sidecar(5) == (host_state, None)


# -- faults (tests/test_resilience.py:195-277) -------------------------------

@pytest.mark.parametrize("bad", ["nope.read:io_error", "data.read:frobnicate",
                                 "data.read", "data.read:io_error@zero",
                                 "data.read:io_error@-1"])
def test_fault_parse_rejects_what_the_reference_rejects(bad):
    with pytest.raises(FaultSpecError):
        FaultInjector.parse(bad)
    with pytest.raises(ref_faults.FaultSpecError):
        ref_faults.FaultInjector.parse(bad)


def test_nth_hit_fires_exactly_once():
    faults.install(FaultInjector.parse("data.read:io_error@3"))
    hits = []
    for _ in range(6):
        try:
            faults.fire("data.read")
            hits.append("ok")
        except FaultInjected:
            hits.append("boom")
    assert hits == ["ok", "ok", "boom", "ok", "ok", "ok"]


@pytest.mark.parametrize("seed", [11, 12])
def test_probability_sequence_equals_the_references(seed):
    def seq(mod):
        inj = mod.FaultInjector.parse("data.read:io_error@0.3", seed=seed)
        out = []
        for _ in range(50):
            try:
                inj.fire("data.read")
                out.append(0)
            except mod.FaultInjected:
                out.append(1)
        return out

    assert seq(faults) == seq(ref_faults) and sum(seq(faults)) > 0
    assert seq(faults) != [0] * 50


def test_faults_are_ioerrors_scoped_to_their_point():
    assert issubclass(FaultInjected, IOError)
    faults.install(FaultInjector.parse("ckpt.save:io_error@1"))
    faults.fire("data.read")
    with pytest.raises(FaultInjected):
        faults.fire("ckpt.save")


def test_corrupt_transform_mangles_bytes_as_the_reference():
    data = bytes(range(64))
    got = FaultInjector.parse("ckpt.sidecar:corrupt@1")
    want = ref_faults.FaultInjector.parse("ckpt.sidecar:corrupt@1")
    mangled = got.transform("ckpt.sidecar", data)
    assert mangled != data
    assert mangled == want.transform("ckpt.sidecar", data)
    assert got.transform("ckpt.sidecar", data) == data  # once only


def test_disabled_hooks_are_noops_and_install_spec_exports_env():
    assert faults.installed() is None
    faults.fire("data.read")
    assert faults.transform("ckpt.sidecar", b"abc") == b"abc"
    faults.install_spec("data.read:io_error@2", seed=9)
    assert os.environ[faults.ENV_SPEC] == "data.read:io_error@2"
    assert os.environ[faults.ENV_SEED] == "9"
    faults.install_spec(None)
    assert faults.ENV_SPEC not in os.environ and faults.installed() is None


def test_fired_fault_journals_and_skips_the_journal_flush_point():
    j = _Journal()
    faults.install(FaultInjector.parse(
        "data.read:io_error@1;journal.flush:io_error@1", journal=j))
    with pytest.raises(FaultInjected):
        faults.fire("data.read")
    with pytest.raises(FaultInjected):
        faults.fire("journal.flush")
    assert [r["point"] for r in j.rows if r["event"] == "fault"] == [
        "data.read"]


def test_journal_flush_fault_drops_the_line_not_the_run(tmp_path):
    faults.install(FaultInjector.parse("journal.flush:io_error@2"))
    j = RunJournal(str(tmp_path / "j.jsonl"), kind="test")
    for note in ("first", "second", "third"):
        j.write("note", note=note)
    j.close("clean_exit")
    faults.install(None)
    rows = read_journal(str(tmp_path / "j.jsonl"))
    assert [e["note"] for e in rows if e["event"] == "note"] == [
        "first", "third"]
    assert j.dropped_lines == 1 and rows[-1]["event"] == "exit"


def test_journal_crash_marker_closers_and_taps(tmp_path):
    path = str(tmp_path / "j.jsonl")
    code = (
        "import sys\n"
        "from deep_vision_tpu_torch.obs.journal import RunJournal\n"
        "j = RunJournal(sys.argv[1], kind='test')\n"
        "j.manifest(config={'a': 1})\n"
        "j.add_closer(lambda: j.write('note', note='closer ran'))\n"
        "j.step(3, loss=float('nan'))\n")  # exits without close()
    proc = subprocess.run([sys.executable, "-c", code, path], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rows = read_journal(path)
    assert [r["event"] for r in rows] == ["run_manifest", "step", "note",
                                          "crash"]
    assert rows[0]["config"] == {"a": 1} and rows[0]["kind"] == "test"
    assert rows[1]["loss"] == "nan" and rows[1]["step"] == 3
    seen = []
    j = RunJournal(str(tmp_path / "k.jsonl"))
    j.add_tap(seen.append)
    j.add_tap(lambda row: 1 / 0)  # a raising tap is swallowed
    j.write("note", note="x")
    j.close()
    assert [r["event"] for r in seen] == ["note", "exit"]
    with open(str(tmp_path / "k.jsonl"), "a") as f:
        f.write('{"event": "no')  # a torn last line
    assert read_journal(str(tmp_path / "k.jsonl"))[-1]["event"] == \
        "_torn_line"


# -- the checkpoint manager (tests/test_resilience.py:490-658) ----------------

def test_sidecar_roundtrip_checksummed(tmp_path):
    cm = _manager(tmp_path)
    cm._write_sidecar(3, {"epoch": 3, "lr": 0.1})
    doc = json.load(open(cm._sidecar_path(3)))
    assert doc["__sidecar_format__"] == 1 and "crc32c" in doc
    assert cm._read_sidecar(3) == ({"epoch": 3, "lr": 0.1}, None)
    assert not [p for p in os.listdir(cm.directory) if ".tmp." in p]


def test_sidecar_rot_detected_by_checksum(tmp_path):
    cm = _manager(tmp_path)
    cm._write_sidecar(3, {"epoch": 3})
    path = cm._sidecar_path(3)
    data = bytearray(open(path, "rb").read())
    data[data.index(b'"epoch"') + 2] ^= 0x01
    open(path, "wb").write(bytes(data))
    host, err = cm._read_sidecar(3)
    assert host is None and "checksum" in err


def test_legacy_plain_json_sidecar_accepted(tmp_path):
    cm = _manager(tmp_path)
    with open(cm._sidecar_path(7), "w") as f:
        json.dump({"epoch": 7}, f)
    assert cm._read_sidecar(7) == ({"epoch": 7}, None)


def test_half_written_sidecar_is_an_error_not_a_crash(tmp_path):
    cm = _manager(tmp_path)
    with open(cm._sidecar_path(2), "w") as f:
        f.write('{"__sidecar_format__": 1, "crc32c": 12, "payl')
    host, err = cm._read_sidecar(2)
    assert host is None and "unreadable" in err


def test_sidecar_write_retries_a_transient_io_error(tmp_path):
    reg = Registry()
    cm = _manager(tmp_path, retry=RetryPolicy(
        name="ckpt.sidecar", max_attempts=3, jitter=0, registry=reg,
        sleep=lambda d: None))
    faults.install(FaultInjector.parse("ckpt.sidecar:io_error@1"))
    cm._write_sidecar(1, {"epoch": 1})
    faults.install(None)
    assert cm._read_sidecar(1) == ({"epoch": 1}, None)
    labels = {"policy": "ckpt.sidecar"}
    assert reg.counter("retry_attempts_total", labels=labels).value == 1
    assert reg.counter("retry_recoveries_total", labels=labels).value == 1


def test_corrupt_fault_caught_by_checksum(tmp_path):
    cm = _manager(tmp_path)
    faults.install(FaultInjector.parse("ckpt.sidecar:corrupt@1"))
    cm._write_sidecar(1, {"epoch": 1})
    faults.install(None)
    host, err = cm._read_sidecar(1)
    assert host is None and err is not None


def test_restore_tree_quarantines_a_corrupt_latest_and_falls_back(tmp_path):
    j = _Journal()
    cm = _manager(tmp_path, journal=j)
    for step in (1, 2, 3):
        assert cm.save_tree(step, _tree(step), host_state={"step": step})
    cm.wait()
    with open(cm._sidecar_path(3), "r+b") as f:
        f.seek(os.path.getsize(cm._sidecar_path(3)) // 2)
        f.write(b"\x00\x00")
    tree, host = cm.restore_tree(_tree(0))
    assert host == {"step": 2} and torch.equal(tree["w"], _tree(2)["w"])
    q = [r for r in j.rows if r["event"] == "ckpt_quarantine"]
    assert len(q) == 1 and q[0]["step"] == 3
    qdir = os.path.join(cm.directory, "quarantine")
    assert sorted(os.listdir(qdir)) == ["3", "host_state_3.json"]
    assert cm.restore_tree(_tree(0))[1] == {"step": 2}  # stays forgotten


def test_missing_sidecar_with_siblings_is_quarantined(tmp_path):
    j = _Journal()
    cm = _manager(tmp_path, journal=j)
    for step in (1, 2):
        cm.save_tree(step, _tree(step), host_state={"step": step})
    cm.wait()
    os.remove(cm._sidecar_path(2))
    tree, host = cm.restore_tree(_tree(0))
    assert host == {"step": 1}
    assert any(r["event"] == "ckpt_quarantine" and r["step"] == 2
               for r in j.rows)


def test_explicit_corrupt_step_raises_instead_of_falling_back(tmp_path):
    cm = _manager(tmp_path)
    for step in (1, 2):
        cm.save_tree(step, _tree(step), host_state={"step": step})
    cm.wait()
    with open(cm._sidecar_path(2), "r+b") as f:
        f.seek(10)
        f.write(b"\xff")
    with pytest.raises(CheckpointCorruptError):
        cm.restore_tree(_tree(0), step=2)
    with pytest.raises(FileNotFoundError):
        cm.restore_tree(_tree(0), step=9)


def test_nothing_valid_left_returns_none(tmp_path):
    assert _manager(tmp_path).restore_tree(_tree(0)) == (None, None)


def test_sidecars_and_steps_follow_max_to_keep(tmp_path):
    cm = _manager(tmp_path, max_to_keep=2)
    for step in (1, 2, 3, 4, 5):
        cm.save_tree(step, _tree(step), host_state={"step": step})
    cm.wait()
    assert cm.all_steps() == [4, 5] == sorted(cm._sidecar_steps())
    assert cm.latest_step() == 5


def test_array_load_failure_quarantines_then_falls_back(tmp_path):
    j = _Journal()
    cm = _manager(tmp_path, journal=j)
    for step in (1, 2):
        cm.save_tree(step, _tree(step), host_state={"step": step})
    cm.wait()
    with open(os.path.join(cm.directory, "2", "state.pt"), "wb") as f:
        f.write(b"not a torch file")
    tree, host = cm.restore_tree(_tree(0))
    assert host == {"step": 1}
    assert "array restore failed" in [r for r in j.rows if r["event"]
                                      == "ckpt_quarantine"][0]["reason"]


def test_a_save_copies_the_state_before_the_next_step_changes_it(tmp_path):
    model = torch.nn.Linear(3, 2)
    state = create_train_state(model, build_optimizer("sgd", 0.1,
                                                      momentum=0.9),
                               torch.zeros(1, 3), device="cpu")
    model(torch.ones(4, 3)).sum().backward()
    state.optimizer.step()
    state.step = 1
    want = {k: v.clone() for k, v in model.state_dict().items()}
    cm = _manager(tmp_path)
    assert cm.save(1, state, host_state={"epoch": 0})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # the next step, while the writer runs
    state.optimizer.step()
    cm.wait()
    fresh = torch.nn.Linear(3, 2)
    other = create_train_state(fresh, build_optimizer("sgd", 0.1,
                                                      momentum=0.9),
                               torch.zeros(1, 3), device="cpu")
    restored, host = cm.restore(other)
    assert host == {"epoch": 0} and restored.step == 1
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert cm.last_save["bytes"] > 0 and cm.last_save["write_ms"] >= \
        cm.last_save["block_ms"]
    assert not cm.save(1, state)  # a step already saved is declined


@pytest.mark.parametrize("mode,values", [
    ("max", [0.3, 0.2, 0.5, 0.5, None, 0.7, 0.9]),
    ("min", [2.0, 2.5, 1.0, 1.0, None, 0.5, 0.25]),
])
def test_best_mode_saves_the_steps_the_reference_saves(tmp_path, monkeypatch,
                                                       mode, values):
    """best_mode keeps a step only when `best_metric` improves, and a
    step without the metric is saved; the last pair repeats a step, which
    neither side writes twice. The reference's decision runs on its own
    code, with orbax's manager replaced by one that declines a step at or
    below the latest, as orbax does."""
    from deep_vision_tpu.core import checkpoint as ref_ckpt

    class _Orbax:
        def __init__(self):
            self.steps = []

        def save(self, step, args=None):
            if self.steps and step <= self.steps[-1]:
                return False
            self.steps.append(step)
            return True

        def all_steps(self):
            return list(self.steps)

    monkeypatch.setattr(ref_ckpt, "state_arrays", lambda state: {})
    ref = ref_ckpt.CheckpointManager(str(tmp_path / "ref"), best_mode=mode,
                                     best_metric="top1")
    ref._mgr = _Orbax()
    model = torch.nn.Linear(3, 2)
    state = create_train_state(model, build_optimizer("sgd", 0.1),
                               torch.zeros(1, 3), device="cpu")
    cm = _manager(tmp_path, best_mode=mode, best_metric="top1",
                  max_to_keep=None)
    steps = [1, 2, 3, 4, 5, 6, 6]
    got, want = [], []
    for step, v in zip(steps, values):
        metrics = {"loss": 1.0} if v is None else {"top1": v}
        got.append(cm.save(step, state, host_state={"step": step},
                           metrics=metrics))
        want.append(ref.save(step, None, host_state={"step": step},
                             metrics=metrics))
        cm.wait()
    assert got == want
    assert cm.all_steps() == ref._mgr.steps == \
        [s for s, ok in zip(steps, want) if ok]


def test_a_failed_write_raises_at_wait(tmp_path):
    cm = _manager(tmp_path, retry=RetryPolicy(max_attempts=1, jitter=0,
                                              sleep=lambda d: None))
    faults.install(FaultInjector.parse("ckpt.sidecar:io_error@1"))
    cm.save_tree(1, _tree(1), host_state={"step": 1})
    with pytest.raises(FaultInjected):
        cm.wait()
    cm.wait()  # the error is raised once


def test_restore_variables_defaults_to_the_card(tmp_path):
    cm = _manager(tmp_path)
    model = torch.nn.Linear(3, 2)
    cm.save(1, create_train_state(model, build_optimizer("sgd", 0.1),
                                  torch.zeros(1, 3), device="cpu"))
    cm.wait()
    got = cm.restore_variables(device="cpu")
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cm.restore_variables()


# -- crash consistency, end to end --------------------------------------------

_SAVER = r"""
import sys
import torch
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager

cm = CheckpointManager(sys.argv[1])
for step in (1, 2, 3):
    cm.save_tree(step, {"w": torch.full((4,), float(step))},
                 host_state={"step": step})
    cm.wait()
print("UNREACHABLE: the injected crash never fired")
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **extra)
    env.pop(faults.ENV_SPEC, None)
    env.update(extra)
    return env


def test_sigkill_mid_save_then_restore_recovers(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    proc = subprocess.run(
        [sys.executable, "-c", _SAVER, ckpt_dir],
        env=_env(**{faults.ENV_SPEC: "ckpt.sidecar:crash_after_write@3"}),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    j = _Journal()
    tree, host = CheckpointManager(ckpt_dir, journal=j).restore_tree(
        {"w": torch.zeros(4)})
    assert host == {"step": 2} and torch.equal(tree["w"], torch.full((4,),
                                                                    2.0))
    assert [r["step"] for r in j.rows if r["event"] == "ckpt_quarantine"] \
        == [3]


def test_cli_run_sigkilled_mid_save_resumes(tmp_path):
    """A tiny CPU CLI run dies by SIGKILL inside the third save's
    sidecar window; the rerun with -c quarantines the torn step, resumes
    from the newest valid one and completes, with a journal that
    check_journal --strict accepts."""
    ckpt_dir = str(tmp_path / "ckpt")
    code = TINY_SETUP + (
        "import sys\nfrom deep_vision_tpu_torch.train_cli import main\n"
        "raise SystemExit(main(sys.argv[1:]))\n")
    base = [sys.executable, "-c", code, "-m", "tiny_s2d", "--fake-data",
            "--fake-batches", "2", "--epochs", "3", "--ckpt-dir", ckpt_dir,
            "--device", "cpu"]
    crashed = subprocess.run(
        base + ["--journal", str(tmp_path / "j1.jsonl")],
        env=_env(**{faults.ENV_SPEC: "ckpt.sidecar:crash_after_write@3"}),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert crashed.returncode == -signal.SIGKILL, (
        crashed.stdout + crashed.stderr)
    resumed = subprocess.run(
        base + ["-c", ckpt_dir, "--journal", str(tmp_path / "j2.jsonl")],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    # 2 batches an epoch: the third save (step 6) was torn, so the run
    # resumes from step 4 and trains epoch 2 again
    assert "resumed from step 4 -> epoch 2" in resumed.stdout
    rows = read_journal(str(tmp_path / "j2.jsonl"))
    assert [r["step"] for r in rows if r["event"] == "ckpt_quarantine"] == [6]
    assert [r["step"] for r in rows if r["event"] == "step"] == [5, 6]
    sys.path.insert(0, ROOT)
    from tools.check_journal import check_journal

    assert check_journal(str(tmp_path / "j2.jsonl"), strict=True) == []
