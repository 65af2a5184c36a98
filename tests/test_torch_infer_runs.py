"""Runs of deep_vision_tpu_torch/tools/infer.py on the CPU, the port
alone (tests/test_torch_infer_cli.py holds it against the JAX package).

- The device rule: cuda by default, raising without a card, as
  train_cli does; --device cpu runs.
- -c restores what the port's train_cli wrote, for each family that
  restores: lenet5 (classification), yolov3_voc (detection),
  hourglass_mpii (pose) and centernet_coco, each trained one step on
  fake data through `train_cli.main`. The forward that infer runs gives
  exactly what the checkpoint's model gives on the same input, and not
  what the seeded initialisation gives.
- Every family writes under -o: the _boxes.txt sidecars and
  _detected.jpg overlays, the _pose.jpg overlays, the _generated.jpg
  images of dcgan_mnist and cyclegan, and with --render the
  _classified.jpg banners of resnet50 (the s2d stem) and vit_s16; a
  --labels file names the classes.
- Without cv2 (its import blocked): detection and pose print the
  reference's "opencv not installed" notes and skip their overlays, the
  sidecars are still written, and cyclegan's images are written by PIL.
Narrowed, for the time on the CPU (copies registered under other names
with monkeypatch): yolov3_voc at 64x64, hourglass_mpii with one stack
(at its 256x256, which the fake heatmaps need), centernet_coco with one
stack at 128x128, cyclegan at 64x64 where cv2 is blocked, and every
batch at 2.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import deep_vision_tpu_torch.models as port_models
from deep_vision_tpu_torch import train_cli
from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, get_config
from deep_vision_tpu_torch.core.checkpoint import CheckpointManager
from deep_vision_tpu_torch.data.datasets import decode_image
from deep_vision_tpu_torch.tools import infer
from torch_infer_parity import WARNING, record_forward, write_jpegs


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    return write_jpegs(tmp_path_factory.mktemp("jpegs"))


def narrow(monkeypatch, name, base, **changes):
    cfg = dataclasses.replace(get_config(base), name=name, batch_size=2,
                              **changes)
    monkeypatch.setitem(CONFIG_REGISTRY, name, cfg)
    return name


def stems(paths):
    return [os.path.splitext(os.path.basename(p))[0] for p in paths]


def leaves(out):
    """The tensors of a model's output (a tensor, a tuple or list, or a
    dict), in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in leaves(out[k])]
    return [t for o in out for t in leaves(o)]


def test_the_default_device_raises_without_a_card(jpegs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        infer.main(["-m", "lenet5", jpegs[0]])
    with pytest.raises(SystemExit):
        infer.main(["-m", "lenet5", "--device", "tpu", jpegs[0]])


RESTORED = {
    "lenet5": ("lenet5", {}, []),
    "yolov3_voc": ("yolov3_64", {"input_shape": (64, 64, 3)},
                   ["--score-threshold", "0.05"]),
    "hourglass_mpii": ("hourglass_1", {"model_kwargs": {
        "num_stack": 1, "num_heatmap": 16}}, []),
    "centernet_coco": ("centernet_128", {"input_shape": (128, 128, 3),
                                         "model_kwargs": {"num_stack": 1}},
                       []),
}


@pytest.mark.parametrize("base", sorted(RESTORED))
def test_c_restores_a_train_cli_checkpoint(monkeypatch, tmp_path, capsys,
                                           jpegs, base):
    name, changes, extra = RESTORED[base]
    name = narrow(monkeypatch, name, base, **changes)
    ck, out = str(tmp_path / "ck"), tmp_path / "out"
    assert train_cli.main(["-m", name, "--fake-data", "--fake-batches",
                           "1", "--epochs", "1", "--ckpt-dir", ck,
                           "--device", "cpu"]) == 0
    step = CheckpointManager(ck).latest_step()
    saved = torch.load(os.path.join(ck, str(step), "state.pt"),
                       weights_only=True)["model"]
    capsys.readouterr()
    log = []
    record_forward(monkeypatch, log)
    assert infer.main(["-m", name, "--device", "cpu", "-c", ck, "-o",
                       str(out), *extra, *jpegs]) == 0
    said = capsys.readouterr().out
    assert WARNING not in said
    (x, got), = log
    cfg = get_config(name)
    kwargs = dict(cfg.model_kwargs)
    if cfg.task != "pose":
        kwargs["num_classes"] = cfg.num_classes
    model = port_models.get_model(cfg.model, device="cpu", **kwargs)
    with torch.inference_mode():
        fresh = leaves(model(torch.from_numpy(x)))
        model.load_state_dict(saved)
        want = leaves(model(torch.from_numpy(x)))
    got = leaves(got)
    assert len(got) == len(want) == len(fresh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert any(not torch.equal(g, f) for g, f in zip(got, fresh))
    if cfg.task == "classification":
        assert [line.split(": ")[0] for line in said.splitlines()] == jpegs
        return
    for stem in stems(jpegs):
        suffix = "_pose.jpg" if cfg.task == "pose" else "_detected.jpg"
        drawn = decode_image((out / f"{stem}{suffix}").read_bytes())
        assert drawn.shape == cfg.input_shape
        if cfg.task != "pose":
            lines = (out / f"{stem}_boxes.txt").read_text().splitlines()
            n = int(said.split(f"{stem}.jpg: ")[1].split()[0])
            assert len([s for s in lines if s]) == n


@pytest.mark.parametrize("name", ["resnet50", "vit_s16"])
def test_classifiers_render_their_banners(tmp_path, capsys, jpegs, name):
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"synset {i}\n" for i in range(1000)))
    out = tmp_path / "out"
    assert infer.main(["-m", name, "--device", "cpu", "--render",
                       "--labels", str(labels), "-o", str(out),
                       *jpegs]) == 0
    said = capsys.readouterr().out.splitlines()
    assert said[0] == WARNING
    for f, stem in zip(jpegs, stems(jpegs)):
        dst = str(out / f"{stem}_classified.jpg")
        line = said.index(f"  wrote {dst}")
        assert said[line - 1].startswith(f"{f}: synset ")
        # the banner is drawn over the display copy at input_shape
        size = get_config(name).input_shape[0]
        assert decode_image(open(dst, "rb").read()).shape == (size, size, 3)


@pytest.mark.parametrize("name,size", [("dcgan_mnist", 28),
                                       ("cyclegan", 256)])
def test_gans_write_their_images(tmp_path, capsys, jpegs, name, size):
    out = tmp_path / "out"
    assert infer.main(["-m", name, "--device", "cpu", "-o", str(out),
                       *jpegs]) == 0
    said = capsys.readouterr().out.splitlines()
    assert said == [WARNING] + [f"{f} -> {out}/{s}_generated.jpg"
                                for f, s in zip(jpegs, stems(jpegs))]
    images = [decode_image((out / f"{s}_generated.jpg").read_bytes())
              for s in stems(jpegs)]
    assert all(im.shape == (size, size, 3) for im in images)
    assert not np.array_equal(images[0], images[1])


def test_without_cv2_the_sidecars_and_images_are_still_written(
        monkeypatch, tmp_path, capsys, jpegs):
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises
    out = tmp_path / "out"
    yolo = narrow(monkeypatch, "yolov3_64", "yolov3_voc",
                  input_shape=(64, 64, 3))
    pose = narrow(monkeypatch, "hourglass_1", "hourglass_mpii",
                  model_kwargs={"num_stack": 1, "num_heatmap": 16})
    gan = narrow(monkeypatch, "cyclegan_64", "cyclegan",
                 input_shape=(64, 64, 3))
    for name in (yolo, pose, gan):
        assert infer.main(["-m", name, "--device", "cpu", "-o", str(out),
                           *jpegs]) == 0
    said = capsys.readouterr().out.splitlines()
    assert ("note: opencv not installed; skipping _detected.jpg overlays "
            "(text sidecars still written)") in said
    assert "note: opencv not installed; skipping _pose.jpg overlays" in said
    for s in stems(jpegs):
        assert (out / f"{s}_boxes.txt").exists()
        assert not (out / f"{s}_detected.jpg").exists()
        assert not (out / f"{s}_pose.jpg").exists()
        assert (out / f"{s}_generated.jpg").read_bytes()[:2] == b"\xff\xd8"
