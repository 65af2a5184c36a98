"""Port parity and runs: train_cli.py's detection task and the V-MoE
classification config, on the CPU through `main([..., "--device",
"cpu"])`.

- `_fake_detection`: the reference's fake batches, bitwise, for both
  registered detection configs.
- The records kind for detection: the train and val loaders' batches on
  VOC records that tools/convert.py wrote, bit for bit against the
  reference's `build_dataloaders`, two epochs (the reshuffle too).
- Runs at a cut size (registered for the test, removed after it): a
  `yolov3_voc` copy at 64 x 64 and batch 2 trains on fake data and on
  converted VOC records, resumes, and `--eval-only` prints mAP@.5 and
  mAP@[.5:.95] from its checkpoint; a `vmoe_s16` copy at 32 x 32
  (vmoe_s16's widths: dim 384, 6 heads, 8 experts; depth 2, so one MoE
  block) trains two steps on fake data and logs the router metrics.
- `--eval-only`'s mAP equals the DetectionEvaluator over the YOLO
  detector's outputs at score 0.1 and the batches' ground truth.
- The pose, centernet, dcgan and cyclegan tasks build their trainers
  (tests/test_torch_gan_pose_cli.py runs them).
"""
import dataclasses

import numpy as np
import pytest
import torch

import deep_vision_tpu.train_cli as ref_cli
from deep_vision_tpu.configs import get_config as ref_get_config
from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, get_config
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.models import MODEL_REGISTRY, get_model
from deep_vision_tpu_torch.models import vit
from deep_vision_tpu_torch.obs.journal import read_journal
from deep_vision_tpu_torch.tools import convert
from deep_vision_tpu_torch.tools.synth_records import write_synth_voc


def cpu_main(*args):
    return train_cli.main([*args, "--device", "cpu"])


@pytest.mark.parametrize("name", ["yolov3_coco", "yolov3_voc"])
def test_fake_detection_batches_are_the_references(name):
    cfg, ref = get_config(name), ref_get_config(name)
    cfg.batch_size = ref.batch_size = 3
    got = train_cli._fake_detection(cfg, 2)
    want = ref_cli._fake_detection(ref, 2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["boxes", "classes", "image"]
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["image"].shape == (3, 416, 416, 3)
    fake = train_cli.build_dataloaders(cfg, "unused", True, 2, 1)[0]()
    np.testing.assert_array_equal(fake[1]["boxes"], want[1]["boxes"])


@pytest.fixture
def tiny_det(monkeypatch):
    """yolov3_voc at 64 x 64, batch 2, registered for one test."""
    cfg = dataclasses.replace(get_config("yolov3_voc"), name="tiny_det",
                              input_shape=(64, 64, 3), batch_size=2,
                              epochs=1)
    monkeypatch.setitem(CONFIG_REGISTRY, "tiny_det", cfg)
    return cfg


@pytest.fixture(scope="module")
def voc_records(tmp_path_factory):
    """Seeded VOC trees converted by tools/convert.py: 6 train, 4 val."""
    d = tmp_path_factory.mktemp("voc")
    for split, n, seed in (("train", 6, 0), ("val", 4, 1)):
        write_synth_voc(str(d / "tree"), split, n, size=80, seed=seed)
        assert convert.main(["voc", "--voc-root", str(d / "tree"),
                             "--split", split, "--out-dir", str(d / "rec"),
                             "--num-shards", "2", "--workers", "1"]) == 0
    return str(d / "rec")


def test_detection_loaders_equal_the_references_bitwise(tiny_det,
                                                        voc_records):
    ref_cfg = dataclasses.replace(ref_get_config("yolov3_voc"),
                                  input_shape=(64, 64, 3), batch_size=2)
    got = train_cli.build_dataloaders(tiny_det, voc_records, False, 0, 2)
    want = ref_cli.build_dataloaders(ref_cfg, voc_records, False, 0, 2)
    for g_fn, w_fn in zip(got, want):
        for _ in range(2):
            g_batches, w_batches = list(g_fn()), list(w_fn())
            assert len(g_batches) == len(w_batches) in (2, 3)
            for g, w in zip(g_batches, w_batches):
                assert sorted(g) == sorted(w)
                for k in g:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    batch = next(iter(got[0]()))
    assert batch["image"].shape == (2, 64, 64, 3)
    assert batch["boxes"].shape == (2, 100, 4)


def test_yolov3_voc_trains_resumes_and_evaluates(tiny_det, voc_records,
                                                 tmp_path, capsys):
    ckpt, journal = str(tmp_path / "ckpt"), str(tmp_path / "run.jsonl")
    assert cpu_main("-m", "tiny_det", "--fake-data", "--fake-batches", "2",
                    "--ckpt-dir", ckpt, "--journal", journal) == 0
    assert cpu_main("-m", "tiny_det", "--data-dir", voc_records,
                    "--ckpt-dir", ckpt, "--journal", journal, "-c", "auto",
                    "--epochs", "2", "--num-workers", "2") == 0
    out = capsys.readouterr().out
    assert "model yolov3:" in out and "resumed from step 2 -> epoch 1" in out
    rows = read_journal(journal)
    steps = [r for r in rows if r["event"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["loss"]) for r in steps)
    evals = [r["summary"] for r in rows if r["event"] == "eval"]
    assert len(evals) == 2 and {"loss", "loss_large", "large_noobj"} <= set(
        evals[0])
    assert CheckpointManager(ckpt).all_steps() == [2, 5]
    assert cpu_main("-m", "tiny_det", "--data-dir", voc_records, "-c", ckpt,
                    "--eval-only") == 0
    out = capsys.readouterr().out
    line = [s for s in out.splitlines() if s.startswith("eval: ")][-1]
    assert line.startswith("eval: mAP@.5=") and "mAP@[.5:.95]=" in line
    assert line.endswith("images=4")


def test_eval_only_is_the_evaluator_over_the_detector(tiny_det):
    """run_eval_only's numbers are DetectionEvaluator's over the YOLO
    detector's detections at score 0.1 (in eval mode, with the model's
    own variables) and the batches' ground truth."""
    from deep_vision_tpu_torch.core.detection_metrics import (
        DetectionEvaluator,
    )
    from deep_vision_tpu_torch.inference import make_yolo_detector

    train_fn, _ = train_cli.build_dataloaders(tiny_det, "unused", True, 2, 1)
    trainer = train_cli.build_trainer(tiny_det, train_fn, None,
                                      steps_per_epoch=2, device="cpu")
    for batch in train_fn():
        trainer.train_step(batch)
    res = train_cli.run_eval_only(tiny_det, trainer, train_fn)
    assert not trainer.model.training
    model = get_model("yolov3", num_classes=20, device="cpu")
    model.load_state_dict(trainer.model.state_dict())
    detect = make_yolo_detector(model, device="cpu", score_threshold=0.1)
    ev = DetectionEvaluator(20)
    n = 0
    for b in train_fn():
        out = detect(dict(model.state_dict()), b["image"])
        n += int(out["num"].sum())
        for i in range(len(b["image"])):
            ev.add(out["boxes"][i].numpy(), out["scores"][i].numpy(),
                   out["classes"][i].numpy(), b["boxes"][i],
                   b["classes"][i])
    want = ev.compute(iou_threshold=0.5)["mAP"]
    assert n > 0
    assert res == {"mAP@.5": want, **ev.compute_coco()}


@pytest.fixture
def tiny_vmoe(monkeypatch):
    """vmoe_s16's widths at depth 2 and 32 x 32, batch 2."""
    def build(num_classes=1000, dtype=None, **_):
        return vit.ViT(depth=2, dim=384, num_heads=6, patch=16,
                       num_classes=num_classes, num_experts=8,
                       image_size=32, dtype=dtype)

    monkeypatch.setitem(MODEL_REGISTRY, "vmoe_s16_d2",
                        (build, vit.reset_parameters))
    cfg = dataclasses.replace(get_config("vmoe_s16"), name="tiny_vmoe",
                              model="vmoe_s16_d2", input_shape=(32, 32, 3),
                              num_classes=10, batch_size=2, epochs=1)
    monkeypatch.setitem(CONFIG_REGISTRY, "tiny_vmoe", cfg)
    return cfg


def test_vmoe_trains_on_fake_data_with_router_metrics(tiny_vmoe, tmp_path,
                                                      capsys):
    journal = str(tmp_path / "run.jsonl")
    assert cpu_main("-m", "tiny_vmoe", "--fake-data", "--fake-batches", "2",
                    "--ckpt-dir", str(tmp_path / "ckpt"), "--journal",
                    journal) == 0
    out = capsys.readouterr().out
    assert "moe_aux=" in out and "router_entropy=" in out
    assert "expert_load_max=" in out
    steps = [r for r in read_journal(journal) if r["event"] == "step"]
    assert len(steps) == 2 and all(np.isfinite(r["loss"]) for r in steps)
    # the cosine schedule of the recipe, warmup included: lr > 0
    assert all(r["lr"] > 0 for r in steps[1:])


def test_unported_tasks_keep_their_refusals(tmp_path):
    """The four last tasks are ported now: pose and centernet build
    their Trainer (at a cut input here), the GAN tasks go to
    build_gan_trainer and Trainer refuses them as the reference does;
    every fake batch and records loader builds, and --eval-only refuses
    only the tasks the reference refuses."""
    from deep_vision_tpu_torch.train.gan import CycleGanTrainer, DcganTrainer

    for name, shape in (("hourglass_mpii", (64, 64, 3)),
                        ("centernet_coco", (128, 128, 3))):
        cfg = dataclasses.replace(get_config(name), input_shape=shape,
                                  batch_size=1)
        trainer = train_cli.build_trainer(cfg, lambda: [], None,
                                          device="cpu", steps_per_epoch=1)
        assert trainer.model.training
    for name, kind in (("dcgan_mnist", DcganTrainer),
                       ("cyclegan", CycleGanTrainer)):
        cfg = dataclasses.replace(get_config(name), input_shape=(
            28, 28, 1) if name == "dcgan_mnist" else (32, 32, 3))
        with pytest.raises(ValueError, match="GAN trainer"):
            train_cli.build_trainer(cfg, lambda: [], None, device="cpu",
                                    steps_per_epoch=1)
        assert isinstance(train_cli.build_gan_trainer(cfg, device="cpu"),
                          kind)
        fake = train_cli.build_dataloaders(cfg, str(tmp_path), True, 1, 1)
        assert fake[0]()[0]["image"].shape[1:] == cfg.input_shape
    with pytest.raises(ValueError, match="unsupported for task 'dcgan'"):
        train_cli.run_eval_only(get_config("dcgan_mnist"), None, None)
