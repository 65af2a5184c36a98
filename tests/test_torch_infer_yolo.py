"""Port parity: deep_vision_tpu_torch/tools/infer.py's detection run
against the JAX package's tools/infer.py on the CPU, on the same JPEGs
and the same weights.

The reference's `main` without -c (its fresh init), its variables caught
where `_restore_variables` returns them, bridged by convert.py into a
port checkpoint that the port's `main(["--device", "cpu", "-c", ...])`
restores: yolov3_voc at --score-threshold 0.05, the same count, classes
and order, boxes and scores within 1e-4. The fresh-init variables get
calibrated running statistics (the batch statistics of each BatchNorm's
input on the two images, by the port's calibrate_batch_stats, written
into the flax tree that the reference's run then uses too): with init
statistics (mean 0, var 1) its 23 residual adds grow the head outputs to
5e3, where the two packages' float32 sums in other orders differ by
0.009 on a tw of a few units and exp(tw) turns that into 3e-4 to 2e-3 of
a box's size, varying between runs (measured). The printed lines agree
in their text and, number by number, within the last printed digit; the
sidecars and overlays are written under -o by both.

Narrowed (a copy registered under another name in both registries with
monkeypatch; nothing in either package changes): yolov3_voc at 128x128.
At 416x416 the JAX side's op-by-op flax init and its jit of the
detector take minutes on the CPU; at 64x64 the deepest BatchNorms
calibrate on 8 rows, whose variance cancels to errors of 1e-4 on both
sides' own rounding; the widths, heads and decode are the registered
ones.
"""
import os

import numpy as np
import pytest
import torch

import deep_vision_tpu.inference as ref_inference
import deep_vision_tpu.tools.infer as ref_infer
import deep_vision_tpu_torch.inference as port_inference
from deep_vision_tpu_torch.data.datasets import decode_image
from deep_vision_tpu_torch.tools.converters import VOC_CLASSES
from torch_infer_parity import (
    assert_printed_alike,
    calibrated,
    record_factory,
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


def test_yolov3_voc_equals_the_reference(monkeypatch, tmp_path, capsys,
                                         jpegs):
    register(monkeypatch, "yolov3_voc_128", "yolov3_voc",
             input_shape=(128, 128, 3))
    got_log, want_log = [], []
    record_factory(monkeypatch, port_inference, "make_yolo_detector",
                   got_log)
    record_factory(monkeypatch, ref_inference, "make_yolo_detector",
                   want_log)
    batch = np.stack([ref_infer._load_image(f, 128, "unit") for f in jpegs])
    got, want = run_both(monkeypatch, tmp_path, capsys, "yolov3_voc_128",
                         jpegs, ["--score-threshold", "0.05"],
                         adjust=calibrated("yolov3", batch, num_classes=20))
    (g,), (w,) = got_log, want_log
    np.testing.assert_array_equal(g["num"], w["num"])
    assert g["num"].min() > 0
    for i, n in enumerate(g["num"]):
        np.testing.assert_array_equal(g["classes"][i, :n],
                                      w["classes"][i, :n])
        for k in ("scores", "boxes"):
            np.testing.assert_allclose(g[k][i, :n], w[k][i, :n], rtol=0,
                                       atol=1e-4, err_msg=k)
    # the VOC names label the lines by default
    assert got[1].split()[0] in VOC_CLASSES
    assert_printed_alike([s for s in got if not s.startswith("  -> ")],
                         [s for s in want if not s.startswith("  -> ")])
    for f in jpegs:
        stem = os.path.splitext(os.path.basename(f))[0]
        sidecars = [(tmp_path / side / f"{stem}_boxes.txt").read_text()
                    .splitlines() for side in ("port", "ref")]
        assert_printed_alike(*sidecars)
        assert decode_image((tmp_path / "port" / f"{stem}_detected.jpg")
                            .read_bytes()).shape == (128, 128, 3)
