"""Port parity: the dataset converters (deep_vision_tpu_torch/tools/
converters.py and the tools/convert.py CLI) against the JAX package's,
on VOC, COCO and flattened-ImageNet trees the tests write, read back
through the port's RecordDataset; and the variable bridge (convert.py)
on the reference's V-MoE tree at a small depth and on YOLOv3's training
variables, batch statistics included.

Tolerances: the records are byte-identical to the reference's (the same
Example fields through byte-identical codecs and writers); boxes read
back equal the annotation's pixel box over the image size, computed in
float64 and stored as float32 on both sides. The bridged models: rtol
1e-4, atol 1e-4 x the largest magnitude (the same float32 formulas,
XLA's and PyTorch's CPU kernels summing in other orders; for YOLOv3
through 75 layers and 72 batch-statistics normalisations). YOLOv3 runs
at 128 x 128 with batch 4, so its smallest BatchNorm normalises 64 rows:
at 64 x 64 and batch 2 (8 rows) the fast variance's cancellation put
errors of 1% on a few outputs, on both sides' own rounding.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_vision_tpu.models import vit as jax_vit
from deep_vision_tpu.models import yolov3 as jax_yolo
from deep_vision_tpu.tools import converters as ref_converters
from deep_vision_tpu_torch.convert import variables_from_jax
from deep_vision_tpu_torch.data import RecordDataset
from deep_vision_tpu_torch.models import get_model
from deep_vision_tpu_torch.models.vit import ViT
from deep_vision_tpu_torch.tools import convert
from deep_vision_tpu_torch.tools import converters
from deep_vision_tpu_torch.tools.synth_records import (
    coco_category_id,
    encode_jpeg,
    write_synth_box_records,
    write_synth_coco,
    write_synth_voc,
)
from torch_parity import close, randomize


def shard_bytes(paths):
    return [open(p, "rb").read() for p in paths]


def read_back(pattern, schema):
    return list(RecordDataset(pattern, schema))


# -- VOC ----------------------------------------------------------------------

def test_voc_converter_equals_the_references_and_reads_back(tmp_path):
    root = str(tmp_path / "VOC")
    ids = write_synth_voc(root, "train", 6, size=48, seed=0)
    annos = converters.voc_annotations(root, "train")
    assert annos == ref_converters.voc_annotations(root, "train")
    got = converters.build_shards(annos, converters.detection_example,
                                  str(tmp_path / "port"), "train", 2,
                                  num_workers=1)
    want = ref_converters.build_shards(
        annos, ref_converters.detection_example, str(tmp_path / "ref"),
        "train", 2, num_workers=1)
    assert [os.path.basename(p) for p in got] == [
        "train_0000_of_0002.tfrecord", "train_0001_of_0002.tfrecord"]
    assert shard_bytes(got) == shard_bytes(want)
    samples = read_back(str(tmp_path / "port" / "train*"), "voc")
    assert len(samples) == len(ids) == 6
    for s, a in zip(samples, annos):
        assert s["image"].shape == (48, 48, 3)
        want_boxes = np.array([[b["xmin"] / 48, b["ymin"] / 48,
                                b["xmax"] / 48, b["ymax"] / 48]
                               for b in a["bboxes"]], np.float32)
        np.testing.assert_array_equal(s["boxes"], want_boxes)
        assert s["classes"].tolist() == [b["class_id"] for b in a["bboxes"]]


def test_voc_boxes_outside_the_image_are_clamped(tmp_path):
    root = tmp_path / "VOC"
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (root / d).mkdir(parents=True)
    (root / "JPEGImages" / "a.jpg").write_bytes(
        encode_jpeg(np.zeros((20, 40, 3), np.uint8)))
    (root / "ImageSets" / "Main" / "val.txt").write_text("a\n")
    (root / "Annotations" / "a.xml").write_text(
        "<annotation><size><width>40</width><height>20</height>"
        "<depth>3</depth></size><object><name>dog</name><bndbox>"
        "<xmin>-4</xmin><ymin>2</ymin><xmax>50</xmax><ymax>10</ymax>"
        "</bndbox></object></annotation>")
    assert convert.main(["voc", "--voc-root", str(root), "--split", "val",
                         "--out-dir", str(tmp_path / "out"),
                         "--num-shards", "1", "--workers", "1"]) == 0
    (s,) = read_back(str(tmp_path / "out" / "val*"), "voc")
    np.testing.assert_allclose(s["boxes"], [[0.0, 0.1, 1.0, 0.5]])
    assert s["classes"].tolist() == [converters.VOC_CLASSES.index("dog")]


# -- COCO ---------------------------------------------------------------------

def test_coco_converter_equals_the_references_and_reads_back(tmp_path):
    js, images = write_synth_coco(str(tmp_path / "coco"), "val", 9, size=40,
                                  num_classes=12, seed=3)
    annos = converters.coco_annotations(js, images)
    assert annos == ref_converters.coco_annotations(js, images)
    assert convert.main(["coco", "--instances-json", js, "--images-dir",
                         images, "--out-dir", str(tmp_path / "port"),
                         "--prefix", "val", "--num-shards", "3",
                         "--workers", "1"]) == 0
    want = ref_converters.build_shards(
        annos, ref_converters.detection_example, str(tmp_path / "ref"),
        "val", 3, num_workers=1)
    got = sorted(str(p) for p in (tmp_path / "port").iterdir())
    assert shard_bytes(got) == shard_bytes(want)
    coco = json.load(open(js))
    crowd = sum(a["iscrowd"] for a in coco["annotations"])
    samples = read_back(str(tmp_path / "port" / "val*"), "coco")
    assert len(samples) == 9 and crowd == 1  # the crowd box is dropped
    assert sum(len(s["boxes"]) for s in samples) == len(
        coco["annotations"]) - crowd
    dense = {coco_category_id(c): c for c in range(12)}
    for s, img in zip(samples, coco["images"]):
        rows = [a for a in coco["annotations"]
                if a["image_id"] == img["id"] and not a["iscrowd"]]
        want_boxes = np.array([[x / 40, y / 40, (x + w) / 40, (y + h) / 40]
                               for x, y, w, h in (a["bbox"] for a in rows)],
                              np.float32)
        np.testing.assert_array_equal(s["boxes"], want_boxes)
        assert s["classes"].tolist() == [dense[a["category_id"]]
                                         for a in rows]


def test_synth_box_records_feed_the_detection_schemas(tmp_path):
    for schema in ("coco", "voc"):
        d = tmp_path / schema
        paths = write_synth_box_records(str(d), schema, count=8, size=32,
                                        shards=2, seed=1)
        assert len(paths) == 4
        train = read_back(str(d / "train*"), schema)
        val = read_back(str(d / "val*"), schema)
        assert (len(train), len(val)) == (8, 2)
        for s in train + val:
            assert s["image"].shape == (32, 32, 3)
            assert len(s["boxes"]) >= 1 and (s["boxes"] >= 0).all() and (
                s["boxes"] <= 1).all()


# -- ImageNet -----------------------------------------------------------------

def test_imagenet_converter_equals_the_references(tmp_path):
    root = tmp_path / "flat"
    root.mkdir()
    synsets = ["n01440764", "n01443537", "n01484850"]
    (tmp_path / "synsets.txt").write_text("\n".join(synsets) + "\n")
    rng = np.random.RandomState(0)
    for i in range(5):
        image = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
        (root / f"{synsets[i % 3]}_{i}.JPEG").write_bytes(encode_jpeg(image))
    annos = converters.imagenet_annotations(str(root),
                                            str(tmp_path / "synsets.txt"))
    want_annos = ref_converters.imagenet_annotations(
        str(root), str(tmp_path / "synsets.txt"))
    assert annos == want_annos
    assert convert.main(["imagenet", "--root", str(root), "--synsets",
                         str(tmp_path / "synsets.txt"), "--out-dir",
                         str(tmp_path / "port"), "--num-shards", "2",
                         "--workers", "1"]) == 0
    want = ref_converters.build_shards(
        want_annos, ref_converters.imagenet_example, str(tmp_path / "ref"),
        "train", 2, num_workers=1)
    got = sorted(str(p) for p in (tmp_path / "port").iterdir())
    assert shard_bytes(got) == shard_bytes(want)
    labels = [int(s["label"]) for s in read_back(
        str(tmp_path / "port" / "train*"), "imagenet")]
    assert labels == [synsets.index(a["synset"]) for a in annos]


def test_unported_subcommands_are_unknown(capsys):
    """Every subcommand of the reference's CLI is known to the port's
    (`--help` exits 0), and one that neither has is refused (exit 2)."""
    from deep_vision_tpu.tools.convert import main as ref_main

    for name in ("voc", "coco", "mpii", "imagenet", "prepare-imagenet",
                 "imagenet_bboxes", "cyclegan", "celeba"):
        for main in (convert.main, ref_main):
            with pytest.raises(SystemExit) as e:
                main([name, "--help"])
            assert e.value.code == 0, name
    with pytest.raises(SystemExit) as e:
        convert.main(["imagenet21k", "--out-dir", "z"])
    assert e.value.code == 2
    assert "invalid choice: 'imagenet21k'" in capsys.readouterr().err


# -- the variable bridge ------------------------------------------------------

def test_vmoe_variables_round_trip_at_a_small_depth():
    """The reference's vmoe_s16 widths (dim 384, 6 heads, 8 experts) at
    depth 2: its variable tree loads strictly and gives its logits."""
    cfg = dict(depth=2, dim=384, num_heads=6, patch=16, num_classes=10,
               num_experts=8)
    jm = jax_vit.ViT(**cfg)
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), train=False))
    v = randomize(shapes, np.random.RandomState(1))
    moe = v["params"]["ViTBlock_1"]["MoeMlp_0"]
    assert {k: np.shape(a) for k, a in moe.items()} == {
        "router": (384, 8), "w1": (8, 384, 1536), "b1": (8, 1536),
        "w2": (8, 1536, 384), "b2": (8, 384)}
    tm = ViT(**cfg, image_size=32)
    tm.load_state_dict(variables_from_jax(v))
    np.testing.assert_array_equal(tm.ViTBlock_1.MoeMlp_0.w1.detach(),
                                  moe["w1"])
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    close(got.numpy(), np.asarray(jm.apply(v, jnp.asarray(x), train=False)),
          1e-4, "logits")


def test_yolov3_training_variables_round_trip():
    """The reference's YOLOv3 variables, batch statistics included, load
    strictly; a training forward then gives its outputs and its updated
    batch statistics."""
    jm = jax_yolo.YoloV3(num_classes=4)
    x = np.random.RandomState(2).rand(4, 128, 128, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), train=False))
    v = randomize(shapes, np.random.RandomState(3))
    # each residual branch's last kernel damped, so 23 adds keep order 1
    for name, block in v["params"]["Darknet53_0"].items():
        if name.startswith("DarknetResidual"):
            block["DarknetConv_1"]["ConvBN_0"]["Conv_0"]["kernel"] *= 0.1
    out, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tm = get_model("yolov3", num_classes=4, device="cpu", train=True)
    tm.load_state_dict(variables_from_jax(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(got, out):
        close(g.numpy(), np.asarray(w), 1e-4, "training output")
    buffers = dict(tm.named_buffers())
    stats = variables_from_jax({"batch_stats": jax.device_get(
        upd["batch_stats"])})
    assert sorted(stats) == sorted(buffers) and len(stats) == 2 * 72
    for k, w in stats.items():
        close(buffers[k].numpy(), w.numpy(), 1e-4, k)
