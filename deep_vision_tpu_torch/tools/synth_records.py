"""Seeded synthetic record shards, written by the port.

    python -m deep_vision_tpu_torch.tools.synth_records DIR [--count 2048]
        [--size 256] [--shards 8] [--encoding raw|jpeg] [--seed 0]
        [--schema imagenet|coco|voc|mpii|image_only]

With the default `imagenet` schema it writes `DIR/train-0000i-of-0000k`:
`count` uniform-noise uint8 RGB images of `size` x `size` from
`numpy.random.default_rng(seed)`, with labels in [0, 1000), as
tf.train.Example records through the port's `RecordWriter`, contiguous
runs of images a shard.

With `coco` or `voc` it writes box records as a user makes them: a
seeded annotation tree under `DIR/tree` (`write_synth_coco`: JPEG files
and an instances JSON with COCO's category-id holes and some crowd
boxes; `write_synth_voc`: a VOCdevkit layout of JPEGs, XML annotations
and ImageSets split lists), `count` train and `count // 4` val images of
`size` x `size`, converted by tools/converters.py into
`DIR/train_*.tfrecord` and `DIR/val_*.tfrecord`, the files the detection
configs read. Each image is noise with 1-4 filled rectangles, each in
its class's colour, and the boxes are those rectangles.

With `mpii` it writes a seeded MPII-layout tree under `DIR/tree`
(`write_synth_mpii`: JPEG files of `size` x `size * 5 // 4` and a
preprocessed people JSON, 16 joints in pixels inside a person box, a
fifth of them unlabelled at (-1, -1) with visibility 0, the person's
centre and scale, box height / 200), `count` train and `count // 4` val
people, converted into `DIR/train_*.tfrecord` and `DIR/val_*.tfrecord`
(the pose config's records). With `image_only` it writes image folders
`DIR/tree/trainA`, `trainB` (`count` JPEGs each) and `val` (`count //
4`), converted one record file a folder into `DIR/trainA_*`,
`DIR/trainB_*` and `DIR/val_*` (CycleGAN's records; its config reads
`train*`, A and B together, and splits each batch in halves).

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
import json
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


def box_image(rng: np.random.Generator, height: int, width: int,
              num_classes: int):
    """Noise with 1-4 filled rectangles in their classes' colours ->
    (image uint8 HWC, pixel boxes [(x1, y1, x2, y2)], classes)."""
    image = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    boxes, classes = [], []
    for _ in range(int(rng.integers(1, 5))):
        bw, bh = rng.uniform(0.1, 0.5) * width, rng.uniform(0.1, 0.5) * height
        x1, y1 = rng.uniform(0, width - bw), rng.uniform(0, height - bh)
        c = int(rng.integers(0, num_classes))
        colour = np.random.default_rng(1000 + c).integers(0, 256, 3)
        image[int(y1):int(y1 + bh), int(x1):int(x1 + bw)] = colour
        boxes.append((float(x1), float(y1), float(x1 + bw), float(y1 + bh)))
        classes.append(c)
    return image, boxes, classes


#: COCO's 80 category ids run from 1 to 90 with holes; the synthetic
#: tree keeps holes so the converter's dense remap is exercised
def coco_category_id(c: int) -> int:
    return 1 + c + c // 8


def write_synth_coco(root: str, split: str, count: int, size: int = 256,
                     num_classes: int = 80, seed: int = 0):
    """A seeded COCO-layout tree: `root/<split>/*.jpg` and
    `root/annotations/instances_<split>.json` (xywh pixel boxes, one
    crowd box every 8th image, which the converter drops). -> (the JSON's
    path, the images' directory)."""
    rng = np.random.default_rng(seed)
    images_dir = os.path.join(root, split)
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, annotations = [], []
    for i in range(count):
        image, boxes, classes = box_image(rng, size, size, num_classes)
        name = f"{seed:04d}{i:08d}.jpg"
        with open(os.path.join(images_dir, name), "wb") as f:
            f.write(encode_jpeg(image))
        images.append({"id": i, "file_name": name, "width": size,
                       "height": size})
        for (x1, y1, x2, y2), c in zip(boxes, classes):
            annotations.append({
                "id": len(annotations), "image_id": i,
                "category_id": coco_category_id(c),
                "bbox": [x1, y1, x2 - x1, y2 - y1], "iscrowd": 0})
        if i % 8 == 7:
            annotations.append({"id": len(annotations), "image_id": i,
                                "category_id": coco_category_id(0),
                                "bbox": [0.0, 0.0, size / 2, size / 2],
                                "iscrowd": 1})
    categories = [{"id": coco_category_id(c), "name": f"class{c}"}
                  for c in range(num_classes)]
    path = os.path.join(root, "annotations", f"instances_{split}.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    return path, images_dir


def write_synth_voc(root: str, split: str, count: int, size: int = 256,
                    seed: int = 0) -> List[str]:
    """A seeded VOCdevkit-layout tree under `root`: JPEGImages/<id>.jpg,
    Annotations/<id>.xml (pixel boxes and VOC class names) and
    ImageSets/Main/<split>.txt. -> the image ids."""
    from deep_vision_tpu_torch.tools.converters import VOC_CLASSES

    rng = np.random.default_rng(seed)
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = []
    for i in range(count):
        image, boxes, classes = box_image(rng, size, size, len(VOC_CLASSES))
        image_id = f"{seed:02d}{i:04d}"
        with open(os.path.join(root, "JPEGImages", f"{image_id}.jpg"),
                  "wb") as f:
            f.write(encode_jpeg(image))
        objects = "".join(
            f"<object><name>{VOC_CLASSES[c]}</name><bndbox>"
            f"<xmin>{x1:.1f}</xmin><ymin>{y1:.1f}</ymin>"
            f"<xmax>{x2:.1f}</xmax><ymax>{y2:.1f}</ymax></bndbox></object>"
            for (x1, y1, x2, y2), c in zip(boxes, classes))
        with open(os.path.join(root, "Annotations", f"{image_id}.xml"),
                  "w") as f:
            f.write(f"<annotation><filename>{image_id}.jpg</filename>"
                    f"<size><width>{size}</width><height>{size}</height>"
                    f"<depth>3</depth></size>{objects}</annotation>")
        ids.append(image_id)
    with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"),
              "w") as f:
        f.write("".join(f"{i}\n" for i in ids))
    return ids


def write_synth_box_records(directory: str, schema: str, count: int = 256,
                            size: int = 256, shards: int = 2,
                            seed: int = 0) -> List[str]:
    """`count` train and `count // 4` val images as a `schema` (coco or
    voc) tree under `directory/tree`, converted into `directory/train_*`
    and `directory/val_*` records. -> the shard paths."""
    from deep_vision_tpu_torch.tools import converters as C

    tree = os.path.join(directory, "tree")
    paths = []
    for split, n, split_seed in (("train", count, seed),
                                 ("val", count // 4, seed + 1)):
        if schema == "coco":
            js, images = write_synth_coco(tree, split, n, size, seed=split_seed)
            annos = C.coco_annotations(js, images)
        elif schema == "voc":
            write_synth_voc(tree, split, n, size, seed=split_seed)
            annos = C.voc_annotations(tree, split)
        else:
            raise ValueError(f"unknown box schema {schema!r} (coco or voc)")
        paths += C.build_shards(annos, C.detection_example, directory, split,
                                shards, num_workers=1)
    return paths


#: MPII's 16 joints (r ankle ... l wrist), as (x, y) fractions of a
#: standing person's box: the synthetic people stand in this pose,
#: jittered
MPII_POSE = ((0.35, 0.98), (0.38, 0.75), (0.42, 0.52), (0.58, 0.52),
             (0.62, 0.75), (0.65, 0.98), (0.5, 0.5), (0.5, 0.28),
             (0.5, 0.18), (0.5, 0.02), (0.2, 0.5), (0.28, 0.4),
             (0.38, 0.22), (0.62, 0.22), (0.72, 0.4), (0.8, 0.5))


def write_synth_mpii(root: str, split: str, count: int, size: int = 256,
                     seed: int = 0):
    """A seeded MPII-layout tree: `root/images/*.jpg` (noise with a
    person box and a dot on each labelled joint) and `root/<split>.json`,
    one person an image. -> (the JSON's path, the images' directory)."""
    rng = np.random.default_rng(seed)
    images_dir = os.path.join(root, "images")
    os.makedirs(images_dir, exist_ok=True)
    height, width = size, size * 5 // 4
    people = []
    for i in range(count):
        image = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        bh = float(rng.uniform(0.5, 0.9) * height)
        bw = bh * 0.5
        x0 = float(rng.uniform(0, width - bw))
        y0 = float(rng.uniform(0, height - bh))
        image[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] //= 2
        vis = (rng.random(len(MPII_POSE)) >= 0.2).astype(int)
        joints = []
        for (fx, fy), v in zip(MPII_POSE, vis):
            x = x0 + (fx + rng.normal(0, 0.03)) * bw
            y = y0 + (fy + rng.normal(0, 0.02)) * bh
            x = float(np.clip(x, 0, width - 1))
            y = float(np.clip(y, 0, height - 1))
            if v:
                image[max(int(y) - 2, 0):int(y) + 3,
                      max(int(x) - 2, 0):int(x) + 3] = 255
                joints.append([x, y])
            else:
                joints.append([-1.0, -1.0])
        name = f"{seed:04d}{i:08d}.jpg"
        with open(os.path.join(images_dir, name), "wb") as f:
            f.write(encode_jpeg(image))
        people.append({"image": name, "joints": joints,
                       "joints_vis": vis.tolist(),
                       "center": [x0 + bw / 2, y0 + bh / 2],
                       "scale": bh / 200.0})
    path = os.path.join(root, f"{split}.json")
    with open(path, "w") as f:
        json.dump(people, f)
    return path, images_dir


def write_synth_image_folder(folder: str, count: int, size: int = 256,
                             seed: int = 0) -> List[str]:
    """`count` seeded `size` x `size` noise JPEGs in `folder`, each with a
    filled rectangle. -> their paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(count):
        image, _, _ = box_image(rng, size, size, 8)
        path = os.path.join(folder, f"{seed:04d}{i:08d}.jpg")
        with open(path, "wb") as f:
            f.write(encode_jpeg(image))
        paths.append(path)
    return paths


def write_synth_pose_records(directory: str, count: int = 256,
                             size: int = 256, shards: int = 2,
                             seed: int = 0) -> List[str]:
    """`count` train and `count // 4` val people as MPII trees under
    `directory/tree`, converted into `directory/train_*` and
    `directory/val_*` keypoint records. -> the shard paths."""
    from deep_vision_tpu_torch.tools import converters as C

    paths = []
    for split, n, split_seed in (("train", count, seed),
                                 ("val", count // 4, seed + 1)):
        js, images = write_synth_mpii(os.path.join(directory, "tree", split),
                                      split, n, size, seed=split_seed)
        paths += C.build_shards(C.mpii_annotations(js, images),
                                C.mpii_example, directory, split, shards,
                                num_workers=1)
    return paths


def write_synth_image_only_records(directory: str, count: int = 256,
                                   size: int = 256,
                                   seed: int = 0) -> List[str]:
    """Image folders trainA and trainB (`count` each) and val (`count //
    4`) under `directory/tree`, each converted into one image-only record
    file `directory/<folder>_0000_of_0001.tfrecord`. -> the paths."""
    from deep_vision_tpu_torch.tools import converters as C

    paths = []
    for i, (folder, n) in enumerate((("trainA", count), ("trainB", count),
                                     ("val", count // 4))):
        images = os.path.join(directory, "tree", folder)
        write_synth_image_folder(images, n, size, seed=seed + i)
        paths += C.build_shards(C.cyclegan_examples(images),
                                C.image_only_example, directory, folder,
                                num_shards=1, num_workers=1)
    return paths


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("directory")
    parser.add_argument("--count", type=int, default=2048)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--shards", type=int, default=8)
    parser.add_argument("--encoding", choices=("raw", "jpeg"), default="raw")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--schema", choices=("imagenet", "coco", "voc",
                                             "mpii", "image_only"),
                        default="imagenet")
    args = parser.parse_args()
    if args.schema == "mpii":
        paths = write_synth_pose_records(args.directory, args.count,
                                         args.size, args.shards, args.seed)
        print(f"wrote {args.count} + {args.count // 4} mpii keypoint "
              f"records in {len(paths)} shards under {args.directory}")
        return
    if args.schema == "image_only":
        paths = write_synth_image_only_records(args.directory, args.count,
                                               args.size, args.seed)
        print(f"wrote 2 x {args.count} + {args.count // 4} image-only "
              f"records in {len(paths)} files under {args.directory}")
        return
    if args.schema != "imagenet":
        paths = write_synth_box_records(args.directory, args.schema,
                                        args.count, args.size, args.shards,
                                        args.seed)
        print(f"wrote {args.count} + {args.count // 4} {args.schema} box "
              f"records in {len(paths)} shards under {args.directory}")
        return
    paths = write_synth_records(args.directory, args.count, args.size,
                                args.shards, args.encoding, args.seed)
    print(f"wrote {args.count} {args.encoding} records in {len(paths)} "
          f"shards under {args.directory}")


if __name__ == "__main__":
    main()
