"""Port parity: the ImageNet bbox CSV, the ImageNet preparation and the
CelebA split of deep_vision_tpu_torch/tools/converters.py and the
tools/convert.py CLI, against the JAX package's on trees the tests
write; the cases of the reference's own tests (tests/test_converters.py
test_celeba_split, test_imagenet_bbox_pipeline, test_prepare_imagenet)
run on the port.

Everything is compared exactly: the CSV's bytes, the prepared trees'
file names and bytes, the split folders, the records' bytes (the same
Example fields through byte-identical codecs and writers), the printed
summaries and the errors' types and messages.
"""
import os
import tarfile

import numpy as np
import pytest

from deep_vision_tpu.tools import converters as ref_converters
from deep_vision_tpu.tools.convert import main as ref_convert_main
from deep_vision_tpu_torch.data import RecordDataset
from deep_vision_tpu_torch.tools import converters
from deep_vision_tpu_torch.tools.convert import main as convert_main
from deep_vision_tpu_torch.tools.synth_records import encode_jpeg

SYNSETS = ("n01440764", "n01443537", "n02119789")
BOX_XML = """<annotation>
  {filename}
  <size><width>{width}</width><height>100</height></size>
  <object><name>{synset}</name>
    <bndbox><xmin>20</xmin><ymin>10</ymin><xmax>100</xmax><ymax>90</ymax></bndbox>
  </object>
  <object><name>{synset}</name>
    <bndbox><xmin>180</xmin><ymin>95</ymin><xmax>150</xmax><ymax>250</ymax></bndbox>
  </object>
  <object><name>n00000000</name>
    <bndbox><xmin>1</xmin><ymin>2</ymin><xmax>3</xmax><ymax>4</ymax></bndbox>
  </object>
</annotation>"""


def write_jpeg(path, seed=0, h=24, w=32):
    image = np.random.RandomState(seed).randint(0, 256, (h, w, 3),
                                                np.uint8)
    with open(path, "wb") as f:
        f.write(encode_jpeg(image))


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for n in files:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def bbox_xml_dir(tmp_path):
    """Per-synset and flat XMLs: normal boxes, an inverted and clamped
    one, an off-challenge synset (a folder and a box), a file without
    <filename>, a degenerate size and a malformed file."""
    xml_dir = tmp_path / "bbox_xml"
    for i, s in enumerate(SYNSETS[:2]):
        os.makedirs(xml_dir / s)
        (xml_dir / s / f"{s}_{i + 1}.xml").write_text(BOX_XML.format(
            filename=f"<filename>{s}_{i + 1}</filename>", width=200,
            synset=s))
    (xml_dir / SYNSETS[0] / f"{SYNSETS[0]}_7.xml").write_text(
        BOX_XML.format(filename="", width=300, synset=SYNSETS[0]))
    (xml_dir / SYNSETS[0] / f"{SYNSETS[0]}_8.xml").write_text(
        BOX_XML.format(filename="<filename>x.jpg</filename>", width=0,
                       synset=SYNSETS[0]))
    (xml_dir / f"{SYNSETS[1]}_9.xml").write_text("<annotation><size>")
    os.makedirs(xml_dir / "n99999999")
    (xml_dir / "n99999999" / "n99999999_5.xml").write_text(BOX_XML.format(
        filename="<filename>n99999999_5</filename>", width=200,
        synset="n99999999"))
    synsets = tmp_path / "synsets.txt"
    synsets.write_text("\n".join(SYNSETS) + "\n")
    return xml_dir, synsets


# -- the bbox CSV ---------------------------------------------------------------

@pytest.mark.parametrize("filtered", [True, False])
def test_bbox_csv_equals_the_references(tmp_path, capsys, filtered):
    xml_dir, synsets = bbox_xml_dir(tmp_path)
    extra = ["--synsets", str(synsets)] if filtered else []
    assert convert_main(["imagenet_bboxes", "--xml-dir", str(xml_dir),
                         "--out-csv", str(tmp_path / "port" / "b.csv"),
                         *extra]) == 0
    said = capsys.readouterr().out
    assert ref_convert_main(["imagenet_bboxes", "--xml-dir", str(xml_dir),
                             "--out-csv", str(tmp_path / "ref" / "b.csv"),
                             *extra]) == 0
    assert said.replace(str(tmp_path / "port"), "") == capsys.readouterr(
    ).out.replace(str(tmp_path / "ref"), "")
    got = (tmp_path / "port" / "b.csv").read_bytes()
    assert got == (tmp_path / "ref" / "b.csv").read_bytes()
    boxes = converters.load_bbox_csv(str(tmp_path / "port" / "b.csv"))
    assert boxes == ref_converters.load_bbox_csv(
        str(tmp_path / "ref" / "b.csv"))
    # the reference test's numbers: the displayed 200x100 size
    # normalises; the inverted x pair swaps and y clamps to [0, 1]
    got = boxes["n01440764_1"]
    np.testing.assert_allclose(got[0], [0.1, 0.1, 0.5, 0.9], atol=1e-4)
    np.testing.assert_allclose(got[1], [0.75, 0.95, 0.9, 1.0], atol=1e-4)
    # an XML without <filename> is named after itself
    assert "n01440764_7" in boxes
    stats = converters.imagenet_bbox_csv(
        str(xml_dir), str(tmp_path / "again.csv"),
        str(synsets) if filtered else None)
    assert stats == ref_converters.imagenet_bbox_csv(
        str(xml_dir), str(tmp_path / "again_ref.csv"),
        str(synsets) if filtered else None)
    assert stats["malformed_files"] == 2
    assert stats["skipped_files"] == (1 if filtered else 0)
    assert stats["skipped_boxes"] == (3 if filtered else 0)
    assert "skipping malformed" in capsys.readouterr().out


def test_load_bbox_csv_keys_on_the_stem_and_skips_short_rows(tmp_path):
    csv = tmp_path / "b.csv"
    csv.write_text("a_1.JPEG,0.1,0.2,0.3,0.4\nbad,row\n"
                   "a_1.JPEG,0.5,0.5,0.6,0.6\nb_2.jpg,0,0,1,1\n")
    got = converters.load_bbox_csv(str(csv))
    assert got == ref_converters.load_bbox_csv(str(csv))
    assert got == {"a_1": [[0.1, 0.2, 0.3, 0.4], [0.5, 0.5, 0.6, 0.6]],
                   "b_2": [[0.0, 0.0, 1.0, 1.0]]}


# -- records with boxes -----------------------------------------------------------

def test_imagenet_records_with_a_bbox_csv_equal_the_references(tmp_path):
    xml_dir, synsets = bbox_xml_dir(tmp_path)
    csv = tmp_path / "b.csv"
    converters.imagenet_bbox_csv(str(xml_dir), str(csv), str(synsets))
    root = tmp_path / "train_flatten"
    os.makedirs(root)
    # .JPEG and .jpg stems match the CSV's .JPEG names; _3 has no box
    for i, name in enumerate(["n01440764_1.JPEG", "n01443537_2.jpg",
                              "n01440764_7.JPEG", "n02119789_3.JPEG"]):
        write_jpeg(root / name, seed=i)
    args = ["imagenet", "--root", str(root), "--synsets", str(synsets),
            "--num-shards", "2", "--workers", "1", "--bbox-csv", str(csv)]
    assert convert_main(args + ["--out-dir", str(tmp_path / "port")]) == 0
    assert ref_convert_main(args + ["--out-dir", str(tmp_path / "ref")]) == 0
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    annos = converters.imagenet_annotations(str(root), str(synsets),
                                            bbox_csv=str(csv))
    assert annos == ref_converters.imagenet_annotations(
        str(root), str(synsets), bbox_csv=str(csv))
    assert [len(a["bboxes"]) for a in annos] == [2, 2, 2, 0]
    ex = converters.imagenet_example(annos[0])
    assert ex == ref_converters.imagenet_example(annos[0])
    np.testing.assert_allclose(ex["image/object/bbox/xmin"], [0.1, 0.75],
                               atol=1e-4)
    np.testing.assert_allclose(ex["image/object/bbox/ymax"], [0.9, 1.0],
                               atol=1e-4)
    assert ex["image/object/bbox/label"] == [1, 1]
    assert "image/object/bbox/xmin" not in converters.imagenet_example(
        annos[3])
    # the classifiers' schema reads them as plain labelled images
    labels = [int(s["label"]) for s in RecordDataset(
        str(tmp_path / "port" / "train*"), "imagenet")]
    assert labels == [SYNSETS.index(a["synset"]) for a in annos]


# -- prepare-imagenet -----------------------------------------------------------

def raw_imagenet(tmp_path):
    """One synset tar, one untarred synset folder, three val images and
    their synset labels."""
    tars = tmp_path / "tars"
    os.makedirs(tars)
    src = tmp_path / "n01440764_10.JPEG"
    write_jpeg(src, seed=1)
    with tarfile.open(tars / "n01440764.tar", "w") as tf:
        tf.add(src, arcname="n01440764_10.JPEG")
        tf.add(src, arcname="sub/n01440764_11.JPEG")
    (tars / "notes.txt").write_text("not a tar")
    sdir = tmp_path / "train_tree" / "n02119789"
    os.makedirs(sdir)
    write_jpeg(sdir / "n02119789_7.JPEG", seed=2)
    (tmp_path / "train_tree" / "README").write_text("a file, not a synset")
    val = tmp_path / "val"
    os.makedirs(val)
    for i in (1, 2, 3):
        write_jpeg(val / f"ILSVRC2012_val_{i:08d}.JPEG", seed=10 + i)
    (val / "LICENSE.txt").write_text("skipped by the extension filter")
    labels = tmp_path / "val_synsets.txt"
    labels.write_text("n02119789\nn01440764\nn01443537\n")
    return tars, tmp_path / "train_tree", val, labels


def test_prepare_imagenet_equals_the_references(tmp_path, capsys):
    tars, train_tree, val, labels = raw_imagenet(tmp_path)
    outs = {}
    for side, main in (("port", convert_main), ("ref", ref_convert_main)):
        out = tmp_path / side
        assert main(["prepare-imagenet", "--out-dir", str(out),
                     "--train-tars", str(tars), "--train-dir",
                     str(train_tree), "--val-dir", str(val),
                     "--val-synsets", str(labels)]) == 0
        outs[side] = capsys.readouterr().out.replace(str(out), "OUT")
    assert outs["port"] == outs["ref"]
    assert outs["port"] == ("prepare-imagenet: 3 train -> OUT/train_flatten,"
                            " 3 val -> OUT/val_flatten\n")
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    assert sorted(os.listdir(tmp_path / "port" / "val_flatten")) == [
        "n01440764_ILSVRC2012_val_00000002.JPEG",
        "n01443537_ILSVRC2012_val_00000003.JPEG",
        "n02119789_ILSVRC2012_val_00000001.JPEG"]
    # a rerun keeps what is there and counts it again
    stats = converters.prepare_imagenet(str(tmp_path / "port"),
                                        train_tars=str(tars))
    assert stats == {"train": 2, "val": 0}
    assert len(os.listdir(tmp_path / "port" / "train_flatten")) == 3
    # the flattened tree is what the converter reads
    synsets = tmp_path / "synsets.txt"
    synsets.write_text("\n".join(SYNSETS) + "\n")
    annos = converters.imagenet_annotations(
        str(tmp_path / "port" / "val_flatten"), str(synsets))
    assert [a["label"] for a in annos] == [1, 2, 3]


def test_prepare_imagenet_moves_when_asked(tmp_path):
    _, train_tree, val, labels = raw_imagenet(tmp_path)
    before = tree(val)
    stats = converters.prepare_imagenet(
        str(tmp_path / "out"), train_dir=str(train_tree), val_dir=str(val),
        val_synsets=str(labels), move=True)
    assert stats == {"train": 1, "val": 3}
    assert os.listdir(train_tree / "n02119789") == []
    assert sorted(os.listdir(val)) == ["LICENSE.txt"]
    got = tree(tmp_path / "out" / "val_flatten")
    assert sorted(got.values()) == sorted(
        v for k, v in before.items() if k.endswith(".JPEG"))


@pytest.mark.parametrize("names,labels,match", [
    (["ILSVRC2012_val_00000001.JPEG", "copy_of_val_2.JPEG"], 2,
     "unrecognized validation"),
    (["ILSVRC2012_val_00000002.JPEG", "ILSVRC2012_val_00000003.JPEG"], 2,
     "gap"),
    (["ILSVRC2012_val_00000001.JPEG"], 2, "1 val images but 2"),
    (["ILSVRC2012_val_00000001.JPEG"], None, "requires val_synsets"),
])
def test_prepare_imagenet_refuses_misaligned_val_sets(tmp_path, names,
                                                      labels, match):
    val = tmp_path / "val"
    os.makedirs(val)
    for i, n in enumerate(names):
        write_jpeg(val / n, seed=i)
    synsets = None
    if labels:
        synsets = tmp_path / "val_synsets.txt"
        synsets.write_text("\n".join(SYNSETS[:labels]) + "\n")
    errors = []
    for fn, side in ((converters.prepare_imagenet, "port"),
                     (ref_converters.prepare_imagenet, "ref")):
        with pytest.raises(ValueError, match=match) as e:
            fn(str(tmp_path / side), val_dir=str(val),
               val_synsets=synsets and str(synsets))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- celeba -----------------------------------------------------------------------

def celeba_tree(tmp_path):
    """The reference test's list_attr_celeba.txt: four rows, 000004's
    image missing on disk."""
    img_dir = tmp_path / "img_align_celeba"
    img_dir.mkdir()
    names = ["000001.jpg", "000002.jpg", "000003.jpg", "000004.jpg"]
    for n in names[:3]:
        (img_dir / n).write_bytes(b"jpegdata-" + n.encode())
    attr = tmp_path / "list_attr_celeba.txt"
    attr.write_text("4\n"
                    "Attractive Male Young\n"
                    "000001.jpg  1  1 -1\n"
                    "000002.jpg -1 -1  1\n"
                    "000003.jpg  1  1  1\n"
                    "000004.jpg -1  1 -1\n")
    return attr, img_dir


@pytest.mark.parametrize("attribute,counts,trainA", [
    ("Male", (2, 1), ["000001.jpg", "000003.jpg"]),
    ("Young", (2, 1), ["000002.jpg", "000003.jpg"]),
    ("Attractive", (2, 1), ["000001.jpg", "000003.jpg"]),
])
def test_celeba_split_equals_the_references(tmp_path, capsys, attribute,
                                            counts, trainA):
    attr, img_dir = celeba_tree(tmp_path)
    args = ["celeba", "--attr-file", str(attr), "--images-dir",
            str(img_dir), "--attribute", attribute]
    assert convert_main(args + ["--out-dir", str(tmp_path / "port")]) == 0
    said = capsys.readouterr().out
    assert ref_convert_main(args + ["--out-dir", str(tmp_path / "ref")]) == 0
    assert said == capsys.readouterr().out
    assert said == ("celeba_split: skipped 1 rows with missing images\n"
                    f"celeba: {counts[0]} -> trainA, {counts[1]} -> trainB\n")
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    assert sorted(os.listdir(tmp_path / "port" / "trainA")) == trainA
    assert (tmp_path / "port" / "trainA" / trainA[0]).read_bytes() == (
        b"jpegdata-" + trainA[0].encode())
    assert converters.celeba_split(
        str(attr), str(img_dir), str(tmp_path / "nocopy"), attribute,
        copy=False) == counts
    assert os.listdir(tmp_path / "nocopy" / "trainA") == []


def test_celeba_split_refusals_equal_the_references(tmp_path):
    attr, img_dir = celeba_tree(tmp_path)
    for fn in (converters.celeba_split, ref_converters.celeba_split):
        with pytest.raises(ValueError, match="'NoSuchAttr' not in"):
            fn(str(attr), str(img_dir), str(tmp_path / "o"), "NoSuchAttr")
        with pytest.raises(FileNotFoundError, match="wrong --images-dir"):
            fn(str(attr), str(tmp_path), str(tmp_path / "o"))
    bad = tmp_path / "bad.txt"
    bad.write_text("1\nMale\n000001.jpg 0\n")
    for fn in (converters.celeba_split, ref_converters.celeba_split):
        with pytest.raises(ValueError, match="bad attribute value 0"):
            fn(str(bad), str(img_dir), str(tmp_path / "o"))
