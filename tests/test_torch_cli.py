"""Port parity: train_cli.py and configs/ against the JAX package's, on
the CPU, through `main([..., "--device", "cpu"])` with a tiny registered
config (a two-stage s2d ResNet of widths 8 and 16, the records' 1000
classes, 32x32 images, batch 8).

Comparisons, each exact unless stated: the registry's configs as data;
`model_input_shape`, the fake batches and the epoch-to-step schedule
conversion against the reference's (schedule values at rtol 1e-6, atol
1e-8: optax evaluates in float32, the port in float64); the ImageNet
loaders' batches on seeded JPEG records, bit for bit, train and val,
both preprocessing chains; every registered config either building its
model or naming the model the port lacks; a train-and-resume run whose
journal `tools/check_journal.py --strict` accepts; `--eval-only`;
unknown flags refused; the entry points defaulting to the card.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import deep_vision_tpu.train_cli as ref_cli
from deep_vision_tpu.configs import CONFIG_REGISTRY as REF_CONFIGS
from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import (
    CONFIG_REGISTRY,
    ExperimentConfig,
    get_config,
    register_config,
)
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.models import MODEL_REGISTRY, register_model
from deep_vision_tpu_torch.models import resnet
from deep_vision_tpu_torch.obs.journal import read_journal
from deep_vision_tpu_torch.tools.synth_records import write_synth_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_CONFIGS = sorted(REF_CONFIGS)


def _tiny(num_classes=1000, dtype=None, stem="s2d", **_):
    return resnet.ResNet(stage_sizes=(1, 1), width=8,
                         num_classes=num_classes, stem=stem, dtype=dtype)


if "resnet_tiny2" not in MODEL_REGISTRY:
    register_model("resnet_tiny2", init=resnet.reset_parameters)(_tiny)
TINY = register_config(ExperimentConfig(
    name="tiny_cli", task="classification", model="resnet_tiny2",
    model_kwargs={"stem": "s2d"}, input_shape=(32, 32, 3), num_classes=1000,
    batch_size=8, epochs=2,
    optimizer={"name": "sgd", "learning_rate": 0.05, "momentum": 0.9,
               "weight_decay": 1e-4},
    plateau={"factor": 0.5, "patience": 0, "mode": "max"},
    dataset={"kind": "imagenet"}, train_resize=40, eval_crop=32))


def cpu_main(*args):
    return train_cli.main([*args, "--device", "cpu"])


# -- the registry ---------------------------------------------------------------

def test_the_registry_is_the_references_as_data():
    assert sorted(set(CONFIG_REGISTRY) - {"tiny_cli"}) == REFERENCE_CONFIGS
    for name in REFERENCE_CONFIGS:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            REF_CONFIGS[name]), name
    cfg = get_config("resnet50")
    cfg.batch_size = 2
    assert get_config("resnet50").batch_size == 256  # a copy
    with pytest.raises(ValueError, match="plateau"):
        ExperimentConfig(name="bad", task="classification", model="lenet5",
                         schedule={"kind": "step", "step_size_epochs": 10},
                         plateau={"factor": 0.1})


@pytest.mark.parametrize("name", REFERENCE_CONFIGS)
def test_every_config_builds_or_names_its_missing_model(name):
    cfg = get_config(name)
    if cfg.model not in MODEL_REGISTRY:
        with pytest.raises(KeyError, match=f"unknown model '{cfg.model}'"):
            train_cli.build_model(cfg, device="cpu")
    else:
        model = train_cli.build_model(cfg, device="cpu")
        assert model.training and sum(p.numel() for p in
                                      model.parameters()) > 0
    if cfg.task in train_cli.GAN_TASKS:
        # the GANs' "models" name their sub-networks' registrations, which
        # build_gan_trainer builds (tests/test_torch_gan_pose_cli.py)
        assert cfg.model not in MODEL_REGISTRY
        with pytest.raises(ValueError, match="uses a GAN trainer"):
            train_cli.build_trainer(cfg, lambda: [], None, device="cpu",
                                    steps_per_epoch=1)


@pytest.mark.parametrize("name", REFERENCE_CONFIGS)
def test_input_shape_and_schedule_conversion_match_the_reference(name):
    cfg = get_config(name)
    assert train_cli.model_input_shape(cfg) == ref_cli.model_input_shape(
        REF_CONFIGS[name])
    got = train_cli._build_schedule(cfg, 7)
    want = ref_cli._build_schedule(REF_CONFIGS[name], 7)
    if not callable(want):
        assert got == want
        return
    for step in range(0, 7 * cfg.epochs + 10, 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-8, err_msg=f"{name} @{step}")


def test_fake_batches_are_the_references():
    got = train_cli._fake_classification(TINY, 3)
    want = ref_cli._fake_classification(TINY, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("image", "label"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["image"].shape == (8, 16, 16, 12)
    assert train_cli._steps_per_epoch(TINY, lambda: got) == 3


# -- the ImageNet loaders ---------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    write_synth_records(str(d / "tfrecord_train"), count=24, size=48,
                        shards=3, encoding="jpeg", seed=0)
    write_synth_records(str(d / "tfrecord_val"), count=8, size=48,
                        shards=1, encoding="jpeg", seed=1)
    return str(d)


@pytest.mark.parametrize("preprocessing", ["torch", "tf"])
def test_imagenet_loaders_equal_the_references_bitwise(records,
                                                       preprocessing):
    got = train_cli.build_dataloaders(TINY, records, False, 0, 2,
                                      preprocessing=preprocessing)
    want = ref_cli.build_dataloaders(TINY, records, False, 0, 2,
                                     preprocessing=preprocessing)
    for g_fn, w_fn in zip(got, want):
        for _ in range(2):  # two epochs: the reshuffle too
            g_batches, w_batches = list(g_fn()), list(w_fn())
            assert len(g_batches) == len(w_batches) > 0
            for g, w in zip(g_batches, w_batches):
                assert sorted(g) == sorted(w)
                for k in g:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]().snapshot_supported()


@pytest.mark.parametrize("kind", ["records"])
def test_unported_dataset_kinds_raise(kind, tmp_path):
    """Every dataset kind of the reference is ported: a records config
    over a directory without shards raises where the reference's does,
    and an unknown kind raises its ValueError."""
    cfg = dataclasses.replace(TINY, dataset={"kind": kind, "schema": "voc"})
    with pytest.raises(FileNotFoundError, match="no record shards"):
        train_cli.build_dataloaders(cfg, str(tmp_path), False, 0, 1)
    with pytest.raises(FileNotFoundError):
        ref_cli.build_dataloaders(cfg, str(tmp_path), False, 0, 1)
    cfg = dataclasses.replace(TINY, dataset={"kind": "folders"})
    with pytest.raises(ValueError, match="unknown dataset kind"):
        train_cli.build_dataloaders(cfg, str(tmp_path), False, 0, 1)


# -- main -----------------------------------------------------------------------

def test_train_then_resume_then_eval_only(tmp_path, capsys):
    ckpt, journal = str(tmp_path / "ckpt"), str(tmp_path / "run.jsonl")
    base = ["-m", "tiny_cli", "--fake-data", "--fake-batches", "2",
            "--ckpt-dir", ckpt, "--journal", journal]
    assert cpu_main(*base, "--epochs", "1", "--ema-decay", "0.9") == 0
    out = capsys.readouterr().out
    assert "precision: cudnn.allow_tf32=" in out and "device cpu" in out
    assert "trainable params" in out
    assert CheckpointManager(ckpt).all_steps() == [2]
    assert cpu_main(*base, "--epochs", "2", "-c", "auto",
                    "--ema-decay", "0.9") == 0
    assert "resumed from step 2 -> epoch 1" in capsys.readouterr().out
    assert CheckpointManager(ckpt).all_steps() == [2, 4]
    assert sorted(os.listdir(os.path.join(ckpt, "ema"))) == [
        "2", "4", "host_state_2.json", "host_state_4.json"]
    rows = read_journal(journal)
    assert [r["step"] for r in rows if r["event"] == "step"] == [1, 2, 3, 4]
    assert [r["event"] for r in rows].count("exit") == 2
    resumed = [r for r in rows if r.get("note") == "resumed"]
    assert len(resumed) == 1 and resumed[0]["restore_ms"] >= 0
    sys.path.insert(0, ROOT)
    from tools.check_journal import check_journal

    assert check_journal(journal, strict=True) == []
    assert cpu_main("-m", "tiny_cli", "--fake-data", "--fake-batches", "2",
                    "-c", ckpt, "--eval-only") == 0
    out = capsys.readouterr().out
    assert "resumed from step 4 -> epoch 2" in out and "eval: loss=" in out


def test_train_from_records_with_a_data_snapshot(records, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert cpu_main("-m", "tiny_cli", "--data-dir", records, "--ckpt-dir",
                    ckpt, "--epochs", "1", "--data-snapshot",
                    "--health-policy", "skip_step", "--num-workers",
                    "2") == 0
    host, err = CheckpointManager(ckpt)._read_sidecar(3)
    assert err is None and host["data_state"]["epoch"] == 1
    assert host["plateau"]["scale"] == 1.0
    with pytest.raises(SystemExit):
        cpu_main("-m", "tiny_cli", "--fake-data", "--data-snapshot")


def test_executable_cache_trains_bitwise_as_without(tmp_path,
                                                    monkeypatch):
    """--executable-cache DIR, and DVT_EXCACHE without the flag, attach
    the cache to the run (its journal valid under --strict) and train
    the same checkpoint bitwise as a run without one."""
    from deep_vision_tpu_torch.core import build

    sys.path.insert(0, ROOT)
    from tools.check_journal import check_journal

    base = ["-m", "tiny_cli", "--fake-data", "--fake-batches", "2",
            "--epochs", "1"]
    assert cpu_main(*base, "--ckpt-dir", str(tmp_path / "plain")) == 0
    journal = str(tmp_path / "run.jsonl")
    try:
        assert cpu_main(*base, "--ckpt-dir", str(tmp_path / "flag"),
                        "--journal", journal, "--executable-cache",
                        str(tmp_path / "excache")) == 0
        assert build._cache.root == str(tmp_path / "excache")
        assert build._cache.journal.path == journal
        build.detach_cache()
        monkeypatch.setenv("DVT_EXCACHE", str(tmp_path / "env"))
        assert cpu_main(*base, "--ckpt-dir", str(tmp_path / "env_ck")) == 0
        assert build._cache.root == str(tmp_path / "env")
    finally:
        build.detach_cache()
    assert check_journal(journal, strict=True) == []
    want = CheckpointManager(str(tmp_path / "plain")).restore_variables(
        device="cpu")
    for run in ("flag", "env_ck"):
        got = CheckpointManager(str(tmp_path / run)).restore_variables(
            device="cpu")
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (run, k)


@pytest.mark.parametrize("flag", ["--autoprof", "--multistep=2",
                                  "--fault-spec=data.read:io_error",
                                  "--profile-dir=p", "--checkify"])
def test_reference_flags_not_ported_are_unknown(flag, capsys):
    with pytest.raises(SystemExit) as e:
        cpu_main("-m", "tiny_cli", "--fake-data", flag)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.main(["-m", "tiny_cli", "--fake-data"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.build_trainer(TINY, lambda: [], None, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.build_model(TINY)
