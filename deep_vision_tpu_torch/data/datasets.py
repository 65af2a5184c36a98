"""Dataset readers: MNIST idx, ImageNet folder, record-backed with schemas.

Parity targets: MnistDataset's idx parser (LeNet/pytorch/data_load.py:24-48),
ImageNet2012Dataset's flattened-folder reader with filename-prefix labels
(ResNet/pytorch/data_load.py:14-69), and the Example schemas of the
reference's converters (ImageNet: build_imagenet_tfrecord.py:184+; VOC/COCO:
Datasets/VOC2007/tfrecords.py:38-95; MPII: tfrecords_mpii.py:65-84).

A Dataset is anything with __len__ + __getitem__(i) -> sample dict (the torch
Dataset contract, kept because it composes with the threaded DataLoader), or
an iterable of sample dicts for record streams.

A port of deep_vision_tpu/data/datasets.py. `decode_image` imports its
image library when it first decodes, in the reference's order (cv2,
else PIL), so the module imports where neither is installed and a
decode there raises ImportError naming both.
"""
from __future__ import annotations

import io
import os
import struct
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from deep_vision_tpu_torch.data.example_codec import decode_example
from deep_vision_tpu_torch.data.records import (
    BadRecordBudgetExceeded,
    best_reader,
    expand_shards,
    read_records_tolerant,
)


def decode_image(data: bytes, channels: int = 3) -> np.ndarray:
    """JPEG/PNG bytes -> HWC uint8 RGB numpy (cv2 fast path, BGR->RGB like
    ResNet/pytorch/data_load.py:53-54; PIL fallback)."""
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("cv2.imdecode failed")
        return img[:, :, ::-1].copy()  # BGR -> RGB
    except Exception as e:  # noqa: BLE001 - the reference's fallback rule
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(
                "decode_image needs cv2 (opencv-python) or PIL (Pillow): "
                f"cv2 gave {type(e).__name__}: {e}, and PIL does not "
                "import") from None
        img = Image.open(io.BytesIO(data))
        img = img.convert("RGB" if channels == 3 else "L")
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr


# -- MNIST idx ---------------------------------------------------------------

class MnistDataset:
    """MNIST idx-format reader (LeNet/pytorch/data_load.py:24-48).

    Unlike the reference (whole set normalized eagerly in __init__), decoding
    is lazy per item; `pad_to_32` reproduces the 28->32 zero-pad for LeNet-5.
    """

    def __init__(self, images_path: str, labels_path: str, pad_to_32: bool = True):
        self.images = self._read_idx(images_path)
        self.labels = self._read_idx(labels_path)
        assert len(self.images) == len(self.labels)
        self.pad_to_32 = pad_to_32

    @staticmethod
    def _read_idx(path: str) -> np.ndarray:
        with open(path, "rb") as f:
            data = f.read()
        zero, dtype_code, ndim = data[0] << 8 | data[1], data[2], data[3]
        assert zero == 0, f"bad idx magic in {path}"
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        shape = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
        arr = np.frombuffer(data, dtypes[dtype_code], offset=4 + 4 * ndim)
        return arr.reshape(shape)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> dict:
        img = self.images[i]
        if img.ndim == 2:
            img = img[:, :, None]
        if self.pad_to_32 and img.shape[0] == 28:
            img = np.pad(img, ((2, 2), (2, 2), (0, 0)))
        return {"image": img, "label": np.int32(self.labels[i])}


# -- ImageNet folder ---------------------------------------------------------

class ImageFolderDataset:
    """Flattened-folder ImageNet reader: label parsed from the filename's
    synset prefix, vocab from synsets.txt (ResNet/pytorch/data_load.py:14-69).
    """

    def __init__(
        self,
        root: str,
        synsets_path: Optional[str] = None,
        extensions: Sequence[str] = (".jpeg", ".jpg", ".png"),
    ):
        self.root = root
        self.files = sorted(
            f for f in os.listdir(root)
            if f.lower().endswith(tuple(extensions))
        )
        if synsets_path:
            with open(synsets_path) as f:
                synsets = [line.strip().split()[0] for line in f if line.strip()]
        else:
            synsets = sorted({f.split("_")[0] for f in self.files})
        self.label_of = {s: i for i, s in enumerate(synsets)}

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        name = self.files[i]
        with open(os.path.join(self.root, name), "rb") as f:
            img = decode_image(f.read())
        synset = name.split("_")[0]
        return {"image": img, "label": np.int32(self.label_of[synset])}


# -- record-backed datasets --------------------------------------------------

def imagenet_schema(feats: Dict[str, list]) -> dict:
    """9-field ImageNet Example (_parse_function at
    ResNet/tensorflow/train.py:150-160; writer build_imagenet_tfrecord.py:184+).
    Labels there are 1-based (0 is background): shift to 0-based."""
    return {
        "image": decode_image(feats["image/encoded"][0]),
        "label": np.int32(feats["image/class/label"][0] - 1),
    }


def _box_schema(feats: Dict[str, list], class_key: str) -> dict:
    n = len(feats.get("image/object/bbox/xmin", ()))
    boxes = np.zeros((n, 4), np.float32)
    if n:
        boxes[:, 0] = feats["image/object/bbox/xmin"]
        boxes[:, 1] = feats["image/object/bbox/ymin"]
        boxes[:, 2] = feats["image/object/bbox/xmax"]
        boxes[:, 3] = feats["image/object/bbox/ymax"]
    classes = np.asarray(feats.get(class_key, [0] * n), np.int32)
    return {
        "image": decode_image(feats["image/encoded"][0]),
        "boxes": boxes,
        "classes": classes,
    }


def voc_schema(feats: Dict[str, list]) -> dict:
    """Normalized-bbox VOC Example (Datasets/VOC2007/tfrecords.py:38-95)."""
    return _box_schema(feats, "image/object/class/label")


def coco_schema(feats: Dict[str, list]) -> dict:
    """COCO Example (Datasets/MSCOCO/tfrecords.py): same bbox layout."""
    return _box_schema(feats, "image/object/class/label")


def mpii_schema(feats: Dict[str, list]) -> dict:
    """MPII keypoint Example (Datasets/MPII/tfrecords_mpii.py:65-84):
    normalized joint x/y + visibility, 16 joints."""
    x = np.asarray(feats["image/person/keypoints/x"], np.float32)
    y = np.asarray(feats["image/person/keypoints/y"], np.float32)
    v = np.asarray(feats["image/person/keypoints/visibility"], np.float32)
    out = {
        "image": decode_image(feats["image/encoded"][0]),
        "keypoints": np.stack([x, y], axis=-1),
        "visibility": v,
    }
    # MPII body height / 200, for CropRoi. ALWAYS present (0.0 = unknown,
    # CropRoi falls back to the keypoint extent): a per-record key would
    # break collate(), which stacks the first sample's keys across the batch
    scale = feats.get("image/person/scale")
    out["scale"] = float(scale[0]) if scale else 0.0
    return out


def image_only_schema(feats: Dict[str, list]) -> dict:
    """Single-image Example (CycleGAN/tensorflow/tfrecords.py)."""
    return {"image": decode_image(feats["image/encoded"][0])}


SCHEMAS: Dict[str, Callable] = {
    "imagenet": imagenet_schema,
    "voc": voc_schema,
    "coco": coco_schema,
    "mpii": mpii_schema,
    "image_only": image_only_schema,
}


class RecordDataset:
    """Iterable dataset over record shards with an Example schema.

    Streams (no random access — record files are sequential by design);
    reshuffles shard order per epoch when `shuffle_shards`.

    With `bad_record_budget` (a `records.BadRecordBudget`), corrupt records
    and failing decodes are SKIPPED under the budget's bound and
    dead-lettered with file + offset instead of killing the epoch — the
    bounded-data-loss mode production runs want against bit rot. The
    budget path uses the Python tolerant reader (the native C++ reader
    keeps strict-raise parity with `read_records`).
    """

    def __init__(
        self,
        pattern,
        schema: str | Callable = "imagenet",
        shuffle_shards: bool = False,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        bad_record_budget=None,
    ):
        self.files = expand_shards(pattern)[shard_index::num_shards]
        self.schema = SCHEMAS[schema] if isinstance(schema, str) else schema
        self.shuffle_shards = shuffle_shards
        self.seed = seed
        self.bad_record_budget = bad_record_budget
        self._epoch = 0
        # optional snapshot.LiveCursor: updated per record read so the
        # DataLoader snapshot can report the shard read frontier
        # (data/snapshot.py); None costs one attribute check per shard
        self.cursor = None

    def set_epoch(self, epoch: int) -> None:
        """Pin the shard-reshuffle epoch (DataLoader `num_procs` mode, where
        the parent process never iterates and so never advances it)."""
        self._epoch = epoch

    def split(self, index: int, count: int) -> "RecordDataset":
        """The index-th of `count` disjoint shard slices (for DataLoader
        `num_procs` worker processes; mirrors the per-host `shard_index`/
        `num_shards` split)."""
        out = RecordDataset.__new__(RecordDataset)
        out.files = self.files[index::count]
        out.schema = self.schema
        out.shuffle_shards = self.shuffle_shards
        out.seed = self.seed + 1000003 * index
        out.bad_record_budget = self.bad_record_budget
        out._epoch = self._epoch
        out.cursor = None  # worker slices never report the parent frontier
        return out

    def _decode(self, raw: bytes) -> dict:
        return self.schema(decode_example(raw))

    def __iter__(self) -> Iterator[dict]:
        files = list(self.files)
        if self.shuffle_shards:
            np.random.RandomState(self.seed + self._epoch).shuffle(files)
        self._epoch += 1
        budget = self.bad_record_budget
        cur = self.cursor
        if cur is not None:
            cur.begin_epoch()
        if budget is None:
            reader = best_reader()
            for si, path in enumerate(files):
                if cur is not None:
                    cur.begin_shard(si, path)
                for raw in reader(path):
                    sample = self._decode(raw)
                    if cur is not None:
                        cur.advance()
                    yield sample
            return
        for si, path in enumerate(files):
            if cur is not None:
                cur.begin_shard(si, path)
            for offset, raw in read_records_tolerant(path, budget):
                try:
                    sample = self._decode(raw)
                except (KeyboardInterrupt, SystemExit,
                        BadRecordBudgetExceeded):
                    raise
                except Exception as e:
                    # undecodable-but-CRC-clean records (writer bug, schema
                    # drift) burn the same budget as corrupt ones
                    budget.record_bad(
                        path, offset,
                        f"decode failed: {type(e).__name__}: {e}")
                    continue
                if cur is not None:
                    cur.advance()
                yield sample
