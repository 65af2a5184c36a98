"""Port parity: the zoo's road through train_cli.py and the Trainer, on
the CPU.

- The `mnist` dataset kind: the port's loaders against the reference's
  (`build_dataloaders`) on seeded idx files, bit for bit, train and val,
  two epochs (the reshuffle too); the idx files the port's
  tools/synth_mnist.py writes read back by the reference's
  `MnistDataset` as written.
- Inception V3's registered `train_resize` 320 and `eval_crop` 299 reach
  the ImageNet chain: its loaders against the reference's on seeded JPEG
  records, bit for bit.
- `main` on `-m lenet5`: train one epoch, resume to two in a fresh
  Trainer, then `--eval-only`, with a journal `tools/check_journal.py
  --strict` accepts.
- The Trainer's dropout stream: each step's masks come from the
  checkpointed generator and the step, so masks differ between steps,
  repeat for the same step, vanish in evaluation, and a run resumed
  from a checkpoint ends bitwise where a straight one does.
- Every zoo config builds through `build_model` and its `build_trainer`
  takes the registered optimizer and schedule.
"""
import os
import sys

import numpy as np
import pytest
import torch

import deep_vision_tpu.train_cli as ref_cli
from deep_vision_tpu.configs import CONFIG_REGISTRY as REF_CONFIGS
from deep_vision_tpu.data import MnistDataset as RefMnist
from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import get_config
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.losses import classification_loss_fn
from deep_vision_tpu_torch.models import mobilenet
from deep_vision_tpu_torch.nn.layers import Dropout, reset_flax_parameters
from deep_vision_tpu_torch.obs.journal import read_journal
from deep_vision_tpu_torch.tools.synth_mnist import (
    synth_digits,
    write_synth_mnist,
)
from deep_vision_tpu_torch.tools.profile_train import ZOO_MODELS
from deep_vision_tpu_torch.tools.synth_records import write_synth_records
from deep_vision_tpu_torch.train import Trainer, build_optimizer
from deep_vision_tpu_torch.train.trainer import dropout_step_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist")
    write_synth_mnist(str(d), train=256, test=96, seed=0)
    return str(d)


def _assert_batches_equal(got_fns, want_fns, epochs=2):
    for g_fn, w_fn in zip(got_fns, want_fns):
        for _ in range(epochs):
            g_batches, w_batches = list(g_fn()), list(w_fn())
            assert len(g_batches) == len(w_batches) > 0
            for g, w in zip(g_batches, w_batches):
                assert sorted(g) == sorted(w)
                for k in g:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_synth_mnist_files_read_back_as_written(mnist):
    images, labels = synth_digits(256, 0)
    ds = RefMnist(os.path.join(mnist, "train-images-idx3-ubyte"),
                  os.path.join(mnist, "train-labels-idx1-ubyte"),
                  pad_to_32=False)
    assert len(ds) == 256
    np.testing.assert_array_equal(ds.images, images)
    np.testing.assert_array_equal(ds.labels, labels)
    assert set(np.unique(labels)) <= set(range(10))


def test_mnist_loaders_equal_the_references_bitwise(mnist):
    cfg = get_config("lenet5")
    cfg.batch_size = 32
    ref = REF_CONFIGS["lenet5"]
    ref = type(ref)(**{**ref.__dict__, "batch_size": 32})
    got = train_cli.build_dataloaders(cfg, mnist, False, 0, 2)
    want = ref_cli.build_dataloaders(ref, mnist, False, 0, 2)
    _assert_batches_equal(got, want)
    first = next(iter(got[1]()))
    assert first["image"].shape == (32, 32, 32, 1)  # 28 padded to 32
    assert first["image"].dtype == np.float32


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    write_synth_records(str(d / "tfrecord_train"), count=8, size=40,
                        shards=2, encoding="jpeg", seed=0)
    write_synth_records(str(d / "tfrecord_val"), count=4, size=40,
                        shards=1, encoding="jpeg", seed=1)
    return str(d)


def test_inception3_crops_reach_the_imagenet_chain(records):
    cfg = get_config("inception3")
    assert (cfg.train_resize, cfg.eval_crop) == (320, 299)
    cfg.batch_size = 4
    ref = type(REF_CONFIGS["inception3"])(
        **{**REF_CONFIGS["inception3"].__dict__, "batch_size": 4})
    got = train_cli.build_dataloaders(cfg, records, False, 0, 2)
    want = ref_cli.build_dataloaders(ref, records, False, 0, 2)
    _assert_batches_equal(got, want, epochs=1)
    for fn in got:
        assert next(iter(fn()))["image"].shape == (4, 299, 299, 3)


def test_lenet5_trains_resumes_and_evaluates(mnist, tmp_path, capsys):
    ckpt, journal = str(tmp_path / "ckpt"), str(tmp_path / "run.jsonl")
    base = ["-m", "lenet5", "--data-dir", mnist, "--ckpt-dir", ckpt,
            "--journal", journal, "--num-workers", "2", "--device", "cpu"]
    assert train_cli.main([*base, "--epochs", "1"]) == 0
    assert "lenet5: 61,706 trainable params" in capsys.readouterr().out
    assert CheckpointManager(ckpt).all_steps() == [4]  # 256 / 64
    assert train_cli.main([*base, "--epochs", "2", "-c", "auto"]) == 0
    assert "resumed from step 4 -> epoch 1" in capsys.readouterr().out
    assert CheckpointManager(ckpt).all_steps() == [4, 8]
    rows = read_journal(journal)
    steps = [r for r in rows if r["event"] == "step"]
    assert [r["step"] for r in steps] == list(range(1, 9))
    assert all(np.isfinite(r["loss"]) for r in steps)
    evals = [r for r in rows if r["event"] == "eval"]
    assert [r["epoch"] for r in evals] == [0, 1]
    sys.path.insert(0, ROOT)
    from tools.check_journal import check_journal

    assert check_journal(journal, strict=True) == []
    assert train_cli.main(["-m", "lenet5", "--data-dir", mnist, "-c", ckpt,
                           "--eval-only", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 8 -> epoch 2" in out and "eval: loss=" in out


def _dropout_trainer(ckpt=None, seed=3):
    """A MobileNet (alpha 0.25, dropout 0.5 before the head) on 32x32."""
    tm = mobilenet.MobileNetV1(10, alpha=0.25, dropout=0.5)
    reset_flax_parameters(tm, torch.Generator().manual_seed(seed))
    return Trainer(tm, build_optimizer("sgd", 0.05, momentum=0.9),
                   classification_loss_fn, torch.zeros(1, 32, 32, 3),
                   device="cpu", checkpoint_manager=(
                       CheckpointManager(ckpt) if ckpt else None))


def _batches(n=3):
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(4, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, 10, 4).astype(np.int32)}
            for _ in range(n)]


def test_dropout_masks_follow_the_step_and_skip_evaluation():
    """The generator state each Dropout draws from (the mask is a
    function of it: tests/test_torch_zoo_layers.py) is new each step,
    the same for the same step, and unused in evaluation."""
    tr = _dropout_trainer()
    (drop,) = [m for m in tr.model.modules() if isinstance(m, Dropout)]
    states, outs = [], []
    drop.register_forward_pre_hook(
        lambda m, args: states.append(m.generator.get_state()))
    drop.register_forward_hook(
        lambda m, args, out: outs.append(torch.equal(out, args[0])))
    batch = _batches(1)[0]
    tr.train_step(batch)
    tr.train_step(batch)
    assert not torch.equal(states[0], states[1])
    tr.state.step = 0
    tr.train_step(batch)
    assert torch.equal(states[0], states[2])
    assert outs == [False] * 3
    tr.eval_step(batch)
    assert outs[3]  # the identity in evaluation
    seeds = {dropout_step_seed(0, s) for s in range(1000)}
    assert len(seeds) == 1000 and dropout_step_seed(1, 0) not in seeds


def test_dropout_stream_resumes_bitwise(tmp_path):
    data = _batches()
    straight = _dropout_trainer()
    straight.fit(lambda: iter(data), epochs=2, handle_preemption=False)
    first = _dropout_trainer(str(tmp_path / "b"))
    first.fit(lambda: iter(data), epochs=1, handle_preemption=False)
    first.close()
    again = _dropout_trainer(str(tmp_path / "b"), seed=4)
    assert again.resume() == 1 and again.state.step == 3
    again.fit(lambda: iter(data), epochs=2, start_epoch=1,
              handle_preemption=False)
    for k, v in straight.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_zoo_configs_build_their_trainers(name):
    """`build_trainer` with the registered optimizer and schedule (or
    plateau) on a width-cut model: every zoo config takes its recipe."""
    cfg = get_config(name)
    small = {"alexnet1": 99, "alexnet2": 95, "vgg16": 32, "vgg19": 32,
             "inception1": 65, "inception3": 107}
    if name in small:
        cfg.model_kwargs = dict(cfg.model_kwargs, image_size=small[name])
        cfg.input_shape = (small[name], small[name], 3)
    elif name in ("mobilenet1", "shufflenet1", "resnet50v2"):
        cfg.input_shape = (64, 64, 3)
    tr = train_cli.build_trainer(cfg, lambda: [], None, steps_per_epoch=3,
                                 device="cpu")
    opt = type(tr.state.optimizer).__name__.lower()
    assert cfg.optimizer["name"] in opt or (
        cfg.optimizer["name"] == "sgd" and "sgd" in opt), opt
    assert (tr.lr_schedule is not None) == (cfg.schedule is not None)
    assert (tr.plateau is not None) == (cfg.plateau is not None)
    assert tr.model.training
