"""Port parity: deep_vision_tpu_torch/tools/infer.py against the JAX
package's tools/infer.py on the CPU, on the same JPEGs and the same
weights.

- The eval chains: `_load_image` in each of its four modes ("imagenet",
  "imagenet_tf", "unit", and the GANs' [-1, 1]) and `_reload_rgb`, on the
  repository's real photos and a seeded JPEG written by
  tools/synth_records.encode_jpeg. Both packages decode and resize with
  cv2 here. The uint8 stages (the decode, the display copy) are equal
  bit for bit; the float outputs within 1e-6.
- What `main` feeds the model: the s2d stem's space_to_depth batch
  ((112, 112, 12) as registered) under both --preprocessing chains, and
  vit_s16's plain ImageNet batch, against the reference's `_load_image`
  and `space_to_depth` (resnet50 narrowed to a 64 crop of a 72 rescale,
  a (32, 32, 12) batch, so the forward is quick; the chain is the same
  code at any size).
- A whole CLI run: the reference's `main` without -c (its fresh init,
  PRNGKey(0) params and PRNGKey(1) dropout), its variables caught where
  `_restore_variables` returns them, bridged by convert.py into a port
  checkpoint that the port's `main(["--device", "cpu", "-c", ...])`
  restores. lenet5 as registered (the mnist grayscale chain): the
  model's input within 1e-6, the top-5 classes equal and the
  probabilities within 1e-5; the printed lines agree in their text and,
  number by number, within the last printed digit. (yolov3_voc's run is
  in test_torch_infer_yolo.py, hourglass_mpii's and dcgan_mnist's in
  test_torch_infer_pose_gan.py, for the time each file takes.)
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import deep_vision_tpu.tools.infer as ref_infer
from deep_vision_tpu.data.datasets import decode_image as ref_decode_image
from deep_vision_tpu.data.transforms import space_to_depth as ref_s2d
from deep_vision_tpu_torch.configs import get_config
from deep_vision_tpu_torch.data.datasets import decode_image
from deep_vision_tpu_torch.tools import infer
from torch_infer_parity import (
    WARNING,
    assert_printed_alike,
    record_forward,
    record_ref_model,
    register,
    run_both,
    write_jpegs,
)

PHOTOS = Path(__file__).parent / "fixtures" / "real_photos"


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    return write_jpegs(tmp_path_factory.mktemp("jpegs"))


# -- the eval chains ----------------------------------------------------------

CHAINS = [("imagenet", 224, 256), ("imagenet", 224, 0),
          ("imagenet_tf", 224, 256), ("unit", 416, 0), ("unit", 32, 0),
          ("gan", 256, 0)]


@pytest.mark.parametrize("mode,size,rescale", CHAINS)
def test_eval_chains_equal_the_references(jpegs, mode, size, rescale):
    for path in sorted(str(p) for p in PHOTOS.glob("*.jpg")) + jpegs:
        data = open(path, "rb").read()
        np.testing.assert_array_equal(decode_image(data),
                                      ref_decode_image(data))
        got = infer._load_image(path, size, mode, rescale=rescale)
        want = ref_infer._load_image(path, size, mode, rescale=rescale)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=path)
        shown = infer._reload_rgb(path, size)
        assert shown.dtype == np.uint8
        np.testing.assert_array_equal(shown, ref_infer._reload_rgb(path,
                                                                   size))


# -- what main feeds the model ------------------------------------------------

@pytest.mark.parametrize("name,pre", [("resnet50", "torch"),
                                      ("resnet50", "tf"),
                                      ("vit_s16", "torch")])
def test_main_feeds_the_references_batch(monkeypatch, jpegs, capsys, name,
                                         pre):
    if name == "resnet50":
        register(monkeypatch, "resnet50_64", "resnet50", eval_crop=64,
                 train_resize=72)
        name = "resnet50_64"
    cfg = get_config(name)
    log = []
    record_forward(monkeypatch, log)
    assert infer.main(["-m", name, "--device", "cpu", "--preprocessing",
                       pre, *jpegs]) == 0
    mode = "imagenet_tf" if pre == "tf" else "imagenet"
    want = np.stack([ref_infer._load_image(f, cfg.eval_crop, mode,
                                           rescale=cfg.train_resize)
                     for f in jpegs])
    if cfg.model_kwargs.get("stem") == "s2d":
        want = np.stack([ref_s2d(im) for im in want])
        assert want.shape == (2, 32, 32, 12)
    else:
        assert want.shape == (2, 224, 224, 3)
    (got, logits), = log
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == WARNING
    assert [line.split(": ")[0] for line in out[1:]] == jpegs
    assert all(len(re.findall(r"class \d+: \d\.\d{3}", line)) == 5
               for line in out[1:])


# -- whole runs, the same weights in both packages ---------------------------

def test_lenet5_equals_the_reference(monkeypatch, tmp_path, capsys, jpegs):
    got_log, want_log = [], []
    record_forward(monkeypatch, got_log)
    record_ref_model(monkeypatch, want_log)
    got, want = run_both(monkeypatch, tmp_path, capsys, "lenet5", jpegs)
    assert_printed_alike(got, want)
    (x, logits), = got_log
    (x_ref, logits_ref), = want_log
    assert x.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-6)

    def softmax(z):
        p = np.exp(z - z.max(-1, keepdims=True))
        return p / p.sum(-1, keepdims=True)

    p, p_ref = softmax(logits.numpy()), softmax(logits_ref)
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.argsort(p)[:, ::-1][:, :5],
                                  np.argsort(p_ref)[:, ::-1][:, :5])
