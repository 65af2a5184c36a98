"""Port parity: deep_vision_tpu_torch/tools/infer.py's pose and DCGAN
runs, and the writer's PIL fallback, a fault of the JAX package's
tools/infer.py that the port keeps, on the CPU. (The other, a GAN run's
checkpoint under -c, is in test_torch_infer_gan_ckpt.py, for the time
each file takes.)

- hourglass_mpii, narrowed to one stack at 64x64 (registered under
  another name in both registries with monkeypatch; nothing in either
  package changes; at four stacks and 256x256 the JAX side's op-by-op
  init takes minutes here): the reference's main without -c, its
  fresh-init variables bridged by convert.py into a port checkpoint that
  the port's main restores with -c. The keypoints' x and y within 1e-4,
  their scores within 1e-4 of the largest (the fresh-init heatmaps reach
  ~2e3, so a score's float32 rounding alone is ~1e-4); the printed lines
  agree in their text, x and y within the last printed digit.
- dcgan_mnist as registered, the same way: the same latent
  (RandomState(0).randn(2, 100)), the generated images as uint8 within
  one level, the printed lines equal, a JPEG written under -o by each.
- The writer's PIL fallback (no cv2): a one-channel image, which is what
  dcgan_mnist generates, raises TypeError in PIL's fromarray in both
  packages, so dcgan_mnist writes nothing on a machine without cv2;
  three channels are written.
"""
import os
import sys

import numpy as np
import pytest
import torch

import deep_vision_tpu.inference as ref_inference
import deep_vision_tpu.tools.infer as ref_infer
import deep_vision_tpu_torch.inference as port_inference
from deep_vision_tpu_torch.data.datasets import decode_image
from deep_vision_tpu_torch.tools import infer
from torch_infer_parity import (
    record_factory,
    record_forward,
    record_ref_model,
    register,
    run_both,
    write_jpegs,
)


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    return write_jpegs(tmp_path_factory.mktemp("jpegs"))


def test_hourglass_equals_the_reference(monkeypatch, tmp_path, capsys,
                                        jpegs):
    register(monkeypatch, "hourglass_64", "hourglass_mpii",
             input_shape=(64, 64, 3),
             model_kwargs={"num_stack": 1, "num_heatmap": 16})
    got_log, want_log = [], []
    record_factory(monkeypatch, port_inference, "make_pose_estimator",
                   got_log)
    record_factory(monkeypatch, ref_inference, "make_pose_estimator",
                   want_log)
    got, want = run_both(monkeypatch, tmp_path, capsys, "hourglass_64",
                         jpegs)
    (g,), (w,) = got_log, want_log
    assert g.shape == w.shape == (2, 16, 3)
    np.testing.assert_allclose(g[..., :2], w[..., :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g[..., 2], w[..., 2], rtol=0,
                               atol=1e-4 * np.abs(w[..., 2]).max())
    assert len(got) == len(want) == 2 * 18
    for gl, wl in zip(got, want):
        if not gl.startswith("  joint "):
            assert gl == wl
            continue
        gx, gy, _ = gl.split(": ")[1].split()
        assert gl.split(": ")[0] == wl.split(": ")[0]
        wx, wy, _ = wl.split(": ")[1].split()
        for a, b in ((gx, wx), (gy, wy)):
            assert a[:2] == b[:2]
            assert abs(float(a[2:]) - float(b[2:])) <= 1.01e-3, (gl, wl)
    for f in jpegs:
        stem = os.path.splitext(os.path.basename(f))[0]
        for side in ("port", "ref"):
            assert f"  -> OUT/{stem}_pose.jpg" in (got if side == "port"
                                                   else want)
            assert decode_image((tmp_path / side / f"{stem}_pose.jpg")
                                .read_bytes()).shape == (64, 64, 3)


def test_dcgan_equals_the_reference(monkeypatch, tmp_path, capsys, jpegs):
    got_log, want_log = [], []
    record_forward(monkeypatch, got_log)
    record_ref_model(monkeypatch, want_log)
    got, want = run_both(monkeypatch, tmp_path, capsys, "dcgan_mnist",
                         jpegs)
    assert got == want == [f"{f} -> OUT/{os.path.basename(f)[:-4]}"
                           f"_generated.jpg" for f in jpegs]
    (z, imgs), = got_log
    (z_ref, imgs_ref), = want_log
    np.testing.assert_array_equal(z, z_ref)
    np.testing.assert_array_equal(
        z, np.random.RandomState(0).randn(2, 100).astype(np.float32))

    def u8(im):
        return np.clip((im + 1.0) * 127.5, 0, 255).astype(np.uint8)

    a, b = u8(imgs.numpy()).astype(int), u8(imgs_ref).astype(int)
    assert a.shape == (2, 28, 28, 1)
    assert np.abs(a - b).max() <= 1
    for f in jpegs:
        name = os.path.basename(f)[:-4] + "_generated.jpg"
        for side in ("port", "ref"):
            assert decode_image((tmp_path / side / name).read_bytes()
                                ).shape == (28, 28, 3)


def test_the_pil_fallback_refuses_one_channel_in_both_packages(
        monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises
    gray = np.full((28, 28, 1), 128, np.uint8)
    rgb = np.full((28, 28, 3), 128, np.uint8)
    for side, write in (("port", infer._write_jpeg),
                        ("ref", ref_infer._write_jpeg)):
        with pytest.raises(TypeError, match="Cannot handle this data type"):
            write(str(tmp_path / f"{side}_gray.jpg"), gray)
        write(str(tmp_path / f"{side}_rgb.jpg"), rgb)
    assert not (tmp_path / "port_gray.jpg").exists()
    got = (tmp_path / "port_rgb.jpg").read_bytes()
    assert got == (tmp_path / "ref_rgb.jpg").read_bytes()
    assert got[:2] == b"\xff\xd8"  # a JPEG, written by PIL
