"""Port parity: data/transforms.py, data/labels.py and decode_image
against the JAX package's own, bit for bit, on the CPU; and the data
package's imports where no image library or google_crc32c is installed.

Every transform gets the same sample and a `numpy.random.Generator` from
the same seed on each side; every output array must be equal in dtype,
shape and every bit. Both sides resize with cv2 here (the reference
picks it at import, the port when it first resizes).
"""
import subprocess
import sys

import numpy as np
import pytest

from deep_vision_tpu.data import datasets as ref_datasets
from deep_vision_tpu.data import labels as ref_labels
from deep_vision_tpu.data import transforms as ref_transforms
from deep_vision_tpu_torch.data import datasets, labels, transforms


def image(seed, h=40, w=52, c=3, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return rng.random((h, w, c), dtype=np.float32)


def boxes_sample(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 0.5, (5, 2))
    wh = rng.uniform(0.05, 0.4, (5, 2))
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    b[3] = 0.0  # a padding row
    return {"image": image(seed), "boxes": b,
            "classes": rng.integers(0, 20, 5).astype(np.int32)}


def pose_sample(seed, scale=1.3):
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0.1, 0.9, (16, 2)).astype(np.float32)
    vis = (rng.random(16) > 0.2).astype(np.float32)
    return {"image": image(seed, 64, 48), "keypoints": kp,
            "visibility": vis, "scale": scale}


# (name, (module -> transform), seed -> sample)
CASES = [
    ("Rescale", lambda T: T.Rescale(32), lambda s: {"image": image(s)}),
    ("Rescale_tall", lambda T: T.Rescale(24),
     lambda s: {"image": image(s, 60, 20)}),
    ("Rescale_gray", lambda T: T.Rescale(20),
     lambda s: {"image": image(s, 30, 40, 1)}),
    ("Resize", lambda T: T.Resize(30, 20), lambda s: {"image": image(s)}),
    ("RandomCrop", lambda T: T.RandomCrop(24), lambda s: {"image": image(s)}),
    ("CenterCrop", lambda T: T.CenterCrop(24), lambda s: {"image": image(s)}),
    ("RandomHorizontalFlip", lambda T: T.RandomHorizontalFlip(),
     boxes_sample),
    ("RandomHorizontalFlip_always", lambda T: T.RandomHorizontalFlip(1.0),
     boxes_sample),
    ("RandomHorizontalFlip_pose", lambda T: T.RandomHorizontalFlip(
        1.0, keypoint_swap_pairs=T.MPII_FLIP_PAIRS), pose_sample),
    ("CropRoi", lambda T: T.CropRoi(0.2), pose_sample),
    ("CropRoi_range", lambda T: T.CropRoi((0.1, 0.3)),
     lambda s: pose_sample(s, scale=0.0)),
    ("RandomCropWithBoxes", lambda T: T.RandomCropWithBoxes(), boxes_sample),
    ("RandomCropWithBoxes_empty", lambda T: T.RandomCropWithBoxes(),
     lambda s: {"image": image(s), "boxes": np.zeros((0, 4), np.float32)}),
    ("ColorJitter", lambda T: T.ColorJitter(0.4, 0.4, 0.4),
     lambda s: {"image": image(s)}),
    ("ColorJitter_hue", lambda T: T.ColorJitter(0.2, 0.3, 0.4, 0.1),
     lambda s: {"image": image(s)}),
    ("ColorJitter_float", lambda T: T.ColorJitter(0.4, 0.0, 0.0),
     lambda s: {"image": image(s, dtype=np.float32)}),
    ("ColorJitter_gray", lambda T: T.ColorJitter(0.3, 0.3, 0.3),
     lambda s: {"image": image(s, c=1)}),
    ("ToFloat", lambda T: T.ToFloat(expand_gray_to_rgb=True),
     lambda s: {"image": image(s, c=1)}),
    ("ToFloat_unscaled", lambda T: T.ToFloat(scale=False),
     lambda s: {"image": image(s)}),
    ("Normalize", lambda T: T.Normalize(),
     lambda s: {"image": image(s, dtype=np.float32)}),
    ("ToFloatNormalize", lambda T: T.ToFloatNormalize(),
     lambda s: {"image": image(s)}),
    ("ToFloatNormalize_gray", lambda T: T.ToFloatNormalize(
        expand_gray_to_rgb=True), lambda s: {"image": image(s, c=1)}),
    ("MeanSubtract", lambda T: T.MeanSubtract(),
     lambda s: {"image": image(s)}),
    ("PadBoxes", lambda T: T.PadBoxes(8), boxes_sample),
    ("PadBoxes_truncate", lambda T: T.PadBoxes(3), boxes_sample),
    ("SpaceToDepth", lambda T: T.SpaceToDepth(),
     lambda s: {"image": image(s, 40, 52)}),
    ("SpaceToDepth_4", lambda T: T.SpaceToDepth(4),
     lambda s: {"image": image(s, 40, 52, dtype=np.float32)}),
    ("MakePoseHeatmaps", lambda T: T.MakePoseHeatmaps(32, 1.5),
     pose_sample),
    ("MakeCenternetTargets", lambda T: T.MakeCenternetTargets(32, 20),
     boxes_sample),
]
LABEL_CLASSES = ("MakePoseHeatmaps", "MakeCenternetTargets")


def module_of(name, side):
    if name.split("_")[0] in LABEL_CLASSES:
        return labels if side == "port" else ref_labels
    return transforms if side == "port" else ref_transforms


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name,make,sample", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_is_bitwise_equal_to_the_reference(name, make, sample,
                                                      seed):
    got = make(module_of(name, "port"))(sample(seed),
                                        np.random.default_rng(seed + 10))
    want = make(module_of(name, "ref"))(sample(seed),
                                        np.random.default_rng(seed + 10))
    assert_same(got, want)


def test_imagenet_chain_with_space_to_depth_is_bitwise_equal():
    def chain(T):
        return [T.Rescale(64), T.RandomHorizontalFlip(), T.RandomCrop(56),
                T.ColorJitter(0.4, 0.4, 0.4),
                T.ToFloatNormalize(expand_gray_to_rgb=True),
                T.SpaceToDepth()]

    for seed in range(4):
        outs = []
        for T in (transforms, ref_transforms):
            sample, rng = {"image": image(seed, 72, 90)}, \
                np.random.default_rng(seed)
            for t in chain(T):
                sample = t(sample, rng)
            outs.append(sample)
        assert outs[0]["image"].shape == (28, 28, 12)
        assert_same(*outs)


@pytest.mark.parametrize("ext", [".jpg", ".png"])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_image_matches_the_reference(ext, seed):
    import cv2

    ok, buf = cv2.imencode(ext, image(seed, 33, 47))
    assert ok
    got = datasets.decode_image(buf.tobytes())
    want = ref_datasets.decode_image(buf.tobytes())
    assert got.shape == (33, 47, 3)
    assert_same({"image": got}, {"image": want})


def test_schemas_match_the_reference():
    import cv2

    from deep_vision_tpu.data.example_codec import decode_example
    from deep_vision_tpu_torch.data.example_codec import encode_example

    ok, buf = cv2.imencode(".png", image(3))
    feats = {"image/encoded": [buf.tobytes()], "image/class/label": [7],
             "image/object/bbox/xmin": [0.1, 0.2],
             "image/object/bbox/ymin": [0.1, 0.3],
             "image/object/bbox/xmax": [0.5, 0.6],
             "image/object/bbox/ymax": [0.4, 0.9],
             "image/object/class/label": [3, 4],
             "image/person/keypoints/x": [0.1] * 16,
             "image/person/keypoints/y": [0.2] * 16,
             "image/person/keypoints/visibility": [1.0] * 16,
             "image/person/scale": [1.5]}
    decoded = decode_example(encode_example(feats))
    assert sorted(datasets.SCHEMAS) == sorted(ref_datasets.SCHEMAS)
    for name in datasets.SCHEMAS:
        assert_same(datasets.SCHEMAS[name](decoded),
                    ref_datasets.SCHEMAS[name](decoded))


def test_mnist_and_image_folder_datasets_match_the_reference(tmp_path):
    import struct

    import cv2

    imgs = image(5, 3 * 28, 28, 1).reshape(3, 28, 28)
    with open(tmp_path / "img", "wb") as f:
        f.write(bytes([0, 0, 0x08, 3]) + struct.pack(">3I", 3, 28, 28))
        f.write(imgs.tobytes())
    with open(tmp_path / "lab", "wb") as f:
        f.write(bytes([0, 0, 0x08, 1]) + struct.pack(">I", 3))
        f.write(bytes([4, 1, 9]))
    got = datasets.MnistDataset(str(tmp_path / "img"), str(tmp_path / "lab"))
    want = ref_datasets.MnistDataset(str(tmp_path / "img"),
                                     str(tmp_path / "lab"))
    assert len(got) == len(want) == 3
    for i in range(3):
        assert_same(got[i], want[i])
    folder = tmp_path / "folder"
    folder.mkdir()
    for i, syn in enumerate(["n02", "n01", "n02"]):
        cv2.imwrite(str(folder / f"{syn}_{i}.png"), image(i, 20, 24))
    got, want = (datasets.ImageFolderDataset(str(folder)),
                 ref_datasets.ImageFolderDataset(str(folder)))
    assert got.files == want.files and got.label_of == want.label_of
    for i in range(3):
        assert_same(got[i], want[i])


BLOCKED = """
import sys
for name in ("cv2", "PIL", "google_crc32c"):
    sys.modules[name] = None
import deep_vision_tpu_torch.data as data
from deep_vision_tpu_torch.data import datasets, transforms
from deep_vision_tpu_torch.tools import synth_records
path = sys.argv[1] + "/shard"
data.write_records(path, [b"a", b"", b"c" * 1000])
assert list(data.read_records(path)) == [b"a", b"", b"c" * 1000]
assert list(data.records.best_reader()(path)) == [b"a", b"", b"c" * 1000]
synth_records.write_synth_records(sys.argv[1], 8, 16, 2, "raw")
ds = data.RecordDataset(sys.argv[1] + "/train-*", synth_records.raw_schema)
images = [s["image"] for s in ds]
assert [i.shape for i in images] == [(16, 16, 3)] * 8
for call in (lambda: datasets.decode_image(b"not an image"),
             lambda: transforms.Rescale(8)({"image": images[0]}, None),
             lambda: synth_records.encode_jpeg(images[0])):
    try:
        call()
    except ImportError as e:
        assert "cv2" in str(e) and "PIL" in str(e), e
    else:
        raise AssertionError("no ImportError")
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("cv2", "PIL", "google_crc32c"))
assert not loaded, loaded
print("ok")
"""


def test_the_data_package_works_without_image_libraries_or_crc32c(tmp_path):
    res = subprocess.run([sys.executable, "-c", BLOCKED, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stderr[-3000:]


def test_importing_every_port_module_loads_no_image_library_or_crc32c():
    from pathlib import Path

    import deep_vision_tpu_torch

    root = Path(deep_vision_tpu_torch.__file__).resolve().parent
    mods = sorted(
        ".".join(p.relative_to(root.parent).with_suffix("").parts)
        .removesuffix(".__init__") for p in root.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'PIL', 'google_crc32c', 'jax', 'deep_vision_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
