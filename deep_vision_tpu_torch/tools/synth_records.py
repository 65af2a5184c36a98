"""Seeded synthetic ImageNet-style record shards, written by the port.

    python -m deep_vision_tpu_torch.tools.synth_records DIR [--count 2048]
        [--size 256] [--shards 8] [--encoding raw|jpeg] [--seed 0]

writes `DIR/train-0000i-of-0000k`: `count` uniform-noise uint8 RGB
images of `size` x `size` from `numpy.random.default_rng(seed)`, with
labels in [0, 1000), as tf.train.Example records through the port's
`RecordWriter`, contiguous runs of images a shard.

Two encodings:

- `raw`: the pixels themselves (`image/raw`, with `image/height`,
  `image/width` and `image/channels`), read back by `raw_schema`, a
  callable schema for `data.RecordDataset`. It needs no image library.
  It is defined here, at module level, so that spawned data workers can
  unpickle it (this module imports no torch and no image library);
- `jpeg`: the reference's ImageNet Example (`image/encoded`, read by the
  `imagenet` schema), encoded with cv2, else PIL, at quality 90.

Labels are stored 1-based, as the ImageNet converter writes them
(`build_imagenet_tfrecord.py`), and both schemas shift them to 0-based.
"""
from __future__ import annotations

import argparse
import io
import os
from typing import Dict, List

import numpy as np

from deep_vision_tpu_torch.data.example_codec import encode_example
from deep_vision_tpu_torch.data.records import RecordWriter

NUM_CLASSES = 1000


def raw_schema(feats: Dict[str, list]) -> dict:
    """A raw-pixel Example -> {"image": HWC uint8, "label": int32}."""
    shape = (feats["image/height"][0], feats["image/width"][0],
             feats["image/channels"][0])
    return {"image": np.frombuffer(feats["image/raw"][0],
                                   np.uint8).reshape(shape),
            "label": np.int32(feats["image/class/label"][0] - 1)}


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """RGB uint8 -> JPEG bytes, with cv2 when it imports, else PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(image[:, :, ::-1]),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise ValueError("cv2.imencode failed")
        return buf.tobytes()
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("JPEG records need cv2 (opencv-python) or PIL "
                          "(Pillow), and neither imports") from None
    out = io.BytesIO()
    Image.fromarray(image).save(out, "JPEG", quality=quality)
    return out.getvalue()


def example(image: np.ndarray, label: int, encoding: str) -> bytes:
    """One image's Example record bytes in `encoding` (raw or jpeg)."""
    if encoding == "raw":
        h, w, c = image.shape
        return encode_example({
            "image/raw": [image.tobytes()], "image/height": [h],
            "image/width": [w], "image/channels": [c],
            "image/class/label": [int(label) + 1]})
    if encoding == "jpeg":
        return encode_example({
            "image/encoded": [encode_jpeg(image)],
            "image/class/label": [int(label) + 1]})
    raise ValueError(f"unknown encoding {encoding!r} (raw or jpeg)")


def write_synth_records(directory: str, count: int = 2048, size: int = 256,
                        shards: int = 8, encoding: str = "raw",
                        seed: int = 0) -> List[str]:
    """Write the shards; returns their paths in order."""
    if count % shards:
        raise ValueError(f"count {count} is not a multiple of {shards}")
    rng = np.random.default_rng(seed)
    per = count // shards
    paths = []
    for i in range(shards):
        path = os.path.join(directory, f"train-{i:05d}-of-{shards:05d}")
        images = rng.integers(0, 256, (per, size, size, 3), dtype=np.uint8)
        labels = rng.integers(0, NUM_CLASSES, per)
        with RecordWriter(path) as w:
            for image, label in zip(images, labels):
                w.write(example(image, label, encoding))
        paths.append(path)
    return paths


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("directory")
    parser.add_argument("--count", type=int, default=2048)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--shards", type=int, default=8)
    parser.add_argument("--encoding", choices=("raw", "jpeg"), default="raw")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    paths = write_synth_records(args.directory, args.count, args.size,
                                args.shards, args.encoding, args.seed)
    print(f"wrote {args.count} {args.encoding} records in {len(paths)} "
          f"shards under {args.directory}")


if __name__ == "__main__":
    main()
