"""Port parity and runs: train_cli.py's pose, centernet, dcgan and cyclegan
tasks, tools/converters.py's MPII and CycleGAN converters, and the two
faults of the reference that the port keeps, on the CPU.

- The fake pose and CenterNet batches: the reference's, bit for bit.
- The records loaders of the pose (MPII records), CenterNet (COCO
  records) and image-only (CycleGAN records) configs: every batch of
  the train and val loaders bit for bit the reference's
  `build_dataloaders`, two epochs of train (the reshuffle too).
- The converters: `tools/convert.py mpii` and `cyclegan` write shards
  byte-identical to the reference's converters on the same trees
  (`synth_records`' seeded MPII JSON with images, and image folders).
- Runs through `main([..., "--device", "cpu"])`, at cut sizes registered
  for one test each (monkeypatch.setitem): dcgan_mnist as registered but
  at batch 8 (`--batch-size`) on fake data, one epoch, then resumed with
  `-c` to a second (the checkpoint of every sub-network an epoch, the
  newest 3 kept); cyclegan at 32x32, its networks at a small width
  (n_blocks=1, base=8), with `--batch-size 2` on converted image-only
  records, two epochs and a resume to three (a checkpoint every 2
  epochs); hourglass_mpii with one stack at batch 2 on converted
  MPII records, then `--eval-only` printing its PCK line; centernet_coco
  with one stack at 128x128 and batch 2 on fake data, then `--eval-only`
  printing mAP@.5 and mAP@[.5:.95].
- The reference's faults, kept: dcgan_mnist on MNIST idx files (padded
  to 32x32 by the dataset, the discriminator built for 28x28) raises in
  both packages at D's Dense_0, 8192 inputs against 6272; cyclegan at
  its registered batch of 1 leaves the B half empty and both image
  pools raise `need at least one array to stack`.
"""
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

import deep_vision_tpu.models as ref_models
import deep_vision_tpu.train.gan as ref_gan
import deep_vision_tpu.train_cli as ref_cli
from deep_vision_tpu.configs import CONFIG_REGISTRY as REF_REGISTRY
from deep_vision_tpu.configs import get_config as ref_get_config
from deep_vision_tpu.tools import converters as ref_converters
import deep_vision_tpu_torch.models as port_models
from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, get_config
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.obs.journal import read_journal
from deep_vision_tpu_torch.tools import convert, converters
from deep_vision_tpu_torch.tools.synth_mnist import write_synth_mnist
from deep_vision_tpu_torch.tools.synth_records import (
    write_synth_box_records,
    write_synth_image_folder,
    write_synth_image_only_records,
    write_synth_mpii,
    write_synth_pose_records,
)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """torch on two threads for each test: with several test processes
    on one host, torch's default of a thread a core oversubscribes the
    cores (a CycleGAN run took 100x its serial time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_main(*args):
    return train_cli.main([*args, "--device", "cpu"])


def shard_bytes(paths):
    return [open(p, "rb").read() for p in sorted(paths)]


def register(monkeypatch, name, base, **changes):
    """A copy of `base` registered as `name` for one test, in the port's
    registry and the reference's."""
    cfg = dataclasses.replace(get_config(base), name=name, **changes)
    ref = dataclasses.replace(ref_get_config(base), name=name, **changes)
    monkeypatch.setitem(CONFIG_REGISTRY, name, cfg)
    monkeypatch.setitem(REF_REGISTRY, name, ref)
    return cfg, ref


def assert_batches_equal(got_fn, want_fn, epochs=1):
    for _ in range(epochs):
        got, want = list(got_fn()), list(want_fn())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- fake batches -------------------------------------------------------------

@pytest.mark.parametrize("name,maker", [("hourglass_mpii", "_fake_pose"),
                                        ("centernet_coco", "_fake_centernet")])
def test_fake_batches_are_the_references(name, maker):
    cfg = dataclasses.replace(get_config(name), batch_size=2,
                              input_shape=(64, 64, 3))
    ref = dataclasses.replace(ref_get_config(name), batch_size=2,
                              input_shape=(64, 64, 3))
    got, want = getattr(train_cli, maker)(cfg, 2), getattr(ref_cli, maker)(
        ref, 2)
    assert_batches_equal(lambda: got, lambda: want)
    for task in ("dcgan", "cyclegan"):
        assert train_cli.FAKE_DATA[task] is train_cli._fake_classification


# -- records: converters and loaders ------------------------------------------

@pytest.fixture(scope="module")
def mpii_records(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mpii"))
    write_synth_pose_records(d, count=8, size=96, shards=2, seed=0)
    return d


def test_mpii_converter_equals_the_references(tmp_path):
    js, images = write_synth_mpii(str(tmp_path / "tree"), "train", 5,
                                  size=40, seed=3)
    annos = converters.mpii_annotations(js, images)
    assert annos == ref_converters.mpii_annotations(js, images)
    assert convert.main(["mpii", "--json", js, "--images-dir", images,
                         "--out-dir", str(tmp_path / "port"),
                         "--num-shards", "2", "--workers", "1"]) == 0
    want = ref_converters.build_shards(annos, ref_converters.mpii_example,
                                       str(tmp_path / "ref"), "train", 2,
                                       num_workers=1)
    got = glob.glob(str(tmp_path / "port" / "train*"))
    assert len(got) == 2
    assert shard_bytes(got) == shard_bytes(want)


def test_cyclegan_converter_equals_the_references(tmp_path):
    folder = str(tmp_path / "trainA")
    write_synth_image_folder(folder, 4, size=24, seed=5)
    open(os.path.join(folder, "notes.txt"), "w").write("skipped")
    annos = converters.cyclegan_examples(folder)
    assert annos == ref_converters.cyclegan_examples(folder)
    assert len(annos) == 4
    assert convert.main(["cyclegan", "--images-dir", folder, "--out-dir",
                         str(tmp_path / "port"), "--workers", "1"]) == 0
    want = ref_converters.build_shards(annos,
                                       ref_converters.image_only_example,
                                       str(tmp_path / "ref"), "trainA", 1,
                                       num_workers=1)
    got = glob.glob(str(tmp_path / "port" / "trainA*"))
    assert shard_bytes(got) == shard_bytes(want)


def test_pose_loaders_equal_the_references_bitwise(monkeypatch, mpii_records):
    cfg, ref = register(monkeypatch, "tiny_pose", "hourglass_mpii",
                        batch_size=2)
    got = train_cli.build_dataloaders(cfg, mpii_records, False, 0, 2)
    want = ref_cli.build_dataloaders(ref, mpii_records, False, 0, 2)
    assert_batches_equal(got[0], want[0], epochs=2)
    assert_batches_equal(got[1], want[1])
    batch = next(iter(got[0]()))
    assert batch["image"].shape == (2, 256, 256, 3)
    assert batch["heatmap"].shape == (2, 64, 64, 16)


def test_centernet_and_image_only_loaders_equal_the_references(
        monkeypatch, tmp_path):
    coco = str(tmp_path / "coco")
    write_synth_box_records(coco, "coco", count=8, size=64, shards=2)
    cfg, ref = register(monkeypatch, "tiny_cn", "centernet_coco",
                        batch_size=2, input_shape=(64, 64, 3))
    got = train_cli.build_dataloaders(cfg, coco, False, 0, 2)
    want = ref_cli.build_dataloaders(ref, coco, False, 0, 2)
    assert_batches_equal(got[0], want[0], epochs=2)
    assert_batches_equal(got[1], want[1])
    assert next(iter(got[0]()))["heatmap"].shape == (2, 16, 16, 80)
    images = str(tmp_path / "images")
    write_synth_image_only_records(images, count=4, size=40, seed=2)
    cfg, ref = register(monkeypatch, "tiny_cyc", "cyclegan", batch_size=2,
                        input_shape=(32, 32, 3))
    got = train_cli.build_dataloaders(cfg, images, False, 0, 2)
    want = ref_cli.build_dataloaders(ref, images, False, 0, 2)
    assert_batches_equal(got[0], want[0], epochs=2)
    batch = next(iter(got[0]()))
    assert batch["image"].shape == (2, 32, 32, 3)
    assert -1.0 <= batch["image"].min() and batch["image"].max() <= 1.0


# -- runs ---------------------------------------------------------------------

def test_dcgan_trains_checkpoints_and_resumes(tmp_path, capsys):
    ckpt, journal = str(tmp_path / "ckpt"), str(tmp_path / "run.jsonl")
    base = ["-m", "dcgan_mnist", "--fake-data", "--fake-batches", "2",
            "--batch-size", "8", "--ckpt-dir", ckpt, "--journal", journal]
    assert cpu_main(*base, "--epochs", "1") == 0
    assert cpu_main(*base, "--epochs", "4", "-c", "auto") == 0
    out = capsys.readouterr().out
    assert "model dcgan: G=2,305,472 D=212,865 trainable params" in out
    assert "resumed GAN training at epoch 1" in out
    epochs = [line for line in out.splitlines() if line.startswith("epoch ")]
    assert [e.split(":")[0] for e in epochs] == [f"epoch {i}"
                                                 for i in range(4)]
    assert all("d_loss=" in e and "g_loss=" in e for e in epochs)
    assert CheckpointManager(ckpt).all_steps() == [4, 6, 8]  # newest 3
    rows = read_journal(journal)
    assert [r["step"] for r in rows if r["event"] == "step"] == list(
        range(1, 9))
    summaries = [r["summary"] for r in rows if r["event"] == "epoch"]
    assert len(summaries) == 4 and all(np.isfinite(s["g_loss"])
                                       for s in summaries)
    with pytest.raises(SystemExit):
        cpu_main(*base, "--eval-only", "-c", "auto")


#: CycleGAN's sub-networks at a small width (the registered widths'
#: parameters are held in test_torch_gan.py)
SMALL_CYCLEGAN = {"cyclegan_generator": {"n_blocks": 1, "base": 8},
                  "cyclegan_discriminator": {"base": 8}}


def small_cyclegan(monkeypatch, models_module):
    """`models_module.get_model` builds CycleGAN's networks small."""
    get_model = models_module.get_model
    monkeypatch.setattr(models_module, "get_model",
                        lambda name, **kw: get_model(name, **{
                            **kw, **SMALL_CYCLEGAN.get(name, {})}))


def test_cyclegan_trains_on_records_and_resumes(monkeypatch, tmp_path,
                                                capsys):
    register(monkeypatch, "tiny_cyc", "cyclegan", input_shape=(32, 32, 3))
    small_cyclegan(monkeypatch, port_models)
    data, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    write_synth_image_only_records(data, count=4, size=40, seed=4)
    base = ["-m", "tiny_cyc", "--data-dir", data, "--batch-size", "2",
            "--ckpt-dir", ckpt, "--num-workers", "2"]
    assert cpu_main(*base, "--epochs", "2") == 0
    # 8 images (trainA and trainB), batch 2: 4 steps an epoch; a
    # checkpoint every 2 epochs
    assert CheckpointManager(ckpt).all_steps() == [8]
    assert cpu_main(*base, "--epochs", "3", "-c", ckpt) == 0
    out = capsys.readouterr().out
    assert ("model cyclegan: G_ab=32,739 G_ba=32,739 D_a=44,761 D_b=44,761 "
            "trainable params") in out
    assert "resumed GAN training at epoch 2" in out
    last = [line for line in out.splitlines()
            if line.startswith("epoch 2: ")]
    assert len(last) == 1
    for key in ("d_loss", "g_adv", "g_cycle", "g_identity", "g_loss"):
        assert f"{key}=" in last[0]
    with pytest.raises(SystemExit):
        cpu_main(*base, "--data-snapshot")


def test_hourglass_trains_on_mpii_records_and_reports_pck(
        monkeypatch, tmp_path, mpii_records, capsys):
    register(monkeypatch, "tiny_pose", "hourglass_mpii", batch_size=2,
             model_kwargs={"num_stack": 1, "num_heatmap": 16})
    ckpt = str(tmp_path / "ckpt")
    assert cpu_main("-m", "tiny_pose", "--data-dir", mpii_records,
                    "--ckpt-dir", ckpt, "--epochs", "1",
                    "--num-workers", "2") == 0
    assert cpu_main("-m", "tiny_pose", "--data-dir", mpii_records, "-c",
                    ckpt, "--eval-only") == 0
    out = capsys.readouterr().out
    line = [s for s in out.splitlines() if s.startswith("eval: ")][-1]
    assert line.startswith("eval: PCK@0.05=") and " visible=" in line


def test_centernet_trains_and_reports_map(monkeypatch, tmp_path, capsys):
    register(monkeypatch, "tiny_cn", "centernet_coco", batch_size=2,
             input_shape=(128, 128, 3), model_kwargs={"num_stack": 1})
    ckpt = str(tmp_path / "ckpt")
    base = ["-m", "tiny_cn", "--fake-data", "--fake-batches", "1"]
    assert cpu_main(*base, "--ckpt-dir", ckpt, "--epochs", "1") == 0
    assert cpu_main(*base, "-c", ckpt, "--eval-only") == 0
    out = capsys.readouterr().out
    assert "model objects_as_points: " in out
    line = [s for s in out.splitlines() if s.startswith("eval: ")][-1]
    assert line.startswith("eval: mAP@.5=") and "mAP@[.5:.95]=" in line
    assert line.endswith("images=2")


# -- the reference's faults, kept ---------------------------------------------

def test_dcgan_on_padded_mnist_raises_in_both_packages(tmp_path):
    data = str(tmp_path / "mnist")
    write_synth_mnist(data, train=16, test=8)
    args = ["-m", "dcgan_mnist", "--data-dir", data, "--batch-size", "8",
            "--epochs", "1", "--num-workers", "1"]
    with pytest.raises(Exception) as ref_err:
        ref_cli.main(args + ["--ckpt-dir", str(tmp_path / "ref")])
    assert type(ref_err.value).__name__ == "ScopeParamShapeError"
    said = str(ref_err.value)
    assert '"kernel" in "/Dense_0"' in said
    assert "(8192, 1)" in said and "(6272, 1)" in said
    with pytest.raises(RuntimeError, match="8x8192 and 6272x1"):
        cpu_main(*args, "--ckpt-dir", str(tmp_path / "port"))


def test_cyclegan_at_batch_one_raises_in_both_packages(monkeypatch,
                                                       tmp_path):
    """The registered batch of 1 (at 32x32 here): the CLI's split gives
    B `images[1:2]`, empty, and ImagePool.query stacks nothing. Both
    packages run small networks (n_blocks=1, base=8; the fault is the
    split's, whatever the width), the reference on one device (the
    tests' 8 CPU devices would refuse a batch of 1 first)."""
    register(monkeypatch, "tiny_cyc1", "cyclegan", input_shape=(32, 32, 3))
    assert get_config("tiny_cyc1").batch_size == 1
    small_cyclegan(monkeypatch, ref_models)
    small_cyclegan(monkeypatch, port_models)
    create_mesh = ref_gan.create_mesh
    monkeypatch.setattr(ref_gan, "create_mesh", lambda: create_mesh(
        devices=jax.devices()[:1]))
    args = ["-m", "tiny_cyc1", "--fake-data", "--fake-batches", "1",
            "--epochs", "1"]
    with pytest.raises(ValueError, match="need at least one array to stack"):
        ref_cli.main(args + ["--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(ValueError, match="need at least one array to stack"):
        cpu_main(*args, "--ckpt-dir", str(tmp_path / "port"))
