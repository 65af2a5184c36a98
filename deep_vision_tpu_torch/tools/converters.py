"""Dataset -> sharded record conversion, the port of
deep_vision_tpu/tools/converters.py:43-273 and :498-584: the VOC, COCO,
MPII, ImageNet and CycleGAN converters, with the reference's field
names, so shards interoperate both ways, written through the port's
`RecordWriter`.

- VOC: XML parse and a normalized-bbox Example (Datasets/VOC2007/
  tfrecords.py:38-95, 124-155), splits from ImageSets/Main (:163-175).
- COCO: instances JSON -> per-image annotations with dense category ids
  (Datasets/MSCOCO/tfrecords.py:135+), the same Example.
- ImageNet: the synset label from the flattened file name and a label
  Example (Datasets/ILSVRC2012/build_imagenet_tfrecord.py:184+).
- MPII: a preprocessed people JSON -> keypoint Examples
  (Datasets/MPII/tfrecords_mpii.py:65-84).
- CycleGAN: a domain folder's images -> image-only Examples.

Shards are written by `multiprocessing.Pool` workers started with
`spawn` (forking a process that runs threads can deadlock), one shard a
chunk. The CelebA split, ImageNet preparation and bbox-CSV converters
are not ported yet.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Sequence

from deep_vision_tpu_torch.data.example_codec import encode_example
from deep_vision_tpu_torch.data.records import RecordWriter

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def chunkify(items: Sequence, n_chunks: int) -> List[List]:
    """Split into n roughly-equal chunks (chunkify, VOC2007/tfrecords.py:20-28)."""
    if not items:
        return []
    n_chunks = max(1, min(n_chunks, len(items)))
    size = -(-len(items) // n_chunks)
    return [list(items[i:i + size]) for i in range(0, len(items), size)]


def _write_shard(args) -> int:
    chunk, path, make_example = args
    n = 0
    with RecordWriter(path) as w:
        for anno in chunk:
            ex = make_example(anno)
            if ex is not None:
                w.write(encode_example(ex))
                n += 1
    return n


def build_shards(
    annotations: Sequence,
    make_example: Callable[[dict], Optional[dict]],
    out_dir: str,
    prefix: str,
    num_shards: int,
    num_workers: Optional[int] = None,
) -> List[str]:
    """Fan annotation chunks out to worker processes, one shard file each.

    Shard naming mirrors the reference: `{prefix}_{i:04d}_of_{n:04d}.tfrecord`.
    """
    os.makedirs(out_dir, exist_ok=True)
    chunks = chunkify(annotations, num_shards)
    jobs = [
        (
            chunk,
            os.path.join(
                out_dir, f"{prefix}_{i:04d}_of_{len(chunks):04d}.tfrecord"
            ),
            make_example,
        )
        for i, chunk in enumerate(chunks)
    ]
    if num_workers is None:
        num_workers = min(len(jobs), os.cpu_count() or 1)
    if num_workers <= 1 or len(jobs) == 1:
        counts = [_write_shard(j) for j in jobs]
    else:
        with mp.get_context("spawn").Pool(num_workers) as pool:
            counts = pool.map(_write_shard, jobs)
    print(f"wrote {sum(counts)} examples to {len(jobs)} shards in {out_dir}")
    return [j[1] for j in jobs]


# -- VOC ------------------------------------------------------------------

def voc_annotations(voc_root: str, split: str = "train") -> List[dict]:
    """Parse VOCdevkit annotations for an ImageSets/Main split
    (VOC2007/tfrecords.py:124-175)."""
    split_file = os.path.join(voc_root, "ImageSets", "Main", f"{split}.txt")
    with open(split_file) as f:
        ids = [line.strip().split()[0] for line in f if line.strip()]
    annos = []
    for image_id in ids:
        xml_path = os.path.join(voc_root, "Annotations", f"{image_id}.xml")
        root = ET.parse(xml_path).getroot()
        size = root.find("size")
        anno = {
            "filename": f"{image_id}.jpg",
            "filepath": os.path.join(voc_root, "JPEGImages", f"{image_id}.jpg"),
            "width": int(size.find("width").text),
            "height": int(size.find("height").text),
            "depth": int(size.find("depth").text or 3),
            "bboxes": [],
        }
        for obj in root.iter("object"):
            name = obj.find("name").text
            box = obj.find("bndbox")
            anno["bboxes"].append(
                {
                    "class_id": VOC_CLASSES.index(name),
                    "class_text": name,
                    "xmin": float(box.find("xmin").text),
                    "ymin": float(box.find("ymin").text),
                    "xmax": float(box.find("xmax").text),
                    "ymax": float(box.find("ymax").text),
                }
            )
        annos.append(anno)
    return annos


def detection_example(anno: dict) -> Optional[dict]:
    """Normalized-bbox Example, exact field names of VOC2007/tfrecords.py:69-93."""
    with open(anno["filepath"], "rb") as f:
        content = f.read()
    w, h = anno["width"], anno["height"]
    xmins, ymins, xmaxs, ymaxs, ids, texts = [], [], [], [], [], []
    for b in anno["bboxes"]:
        xmin, ymin = b["xmin"] / w, b["ymin"] / h
        xmax, ymax = b["xmax"] / w, b["ymax"] / h
        if not all(0.0 <= v <= 1.0 for v in (xmin, ymin, xmax, ymax)):
            # reference hard-asserts (tfrecords.py:61-64); tolerate + clamp
            xmin, ymin = max(0.0, min(1.0, xmin)), max(0.0, min(1.0, ymin))
            xmax, ymax = max(0.0, min(1.0, xmax)), max(0.0, min(1.0, ymax))
        xmins.append(xmin)
        ymins.append(ymin)
        xmaxs.append(xmax)
        ymaxs.append(ymax)
        ids.append(int(b["class_id"]))
        texts.append(b["class_text"].encode())
    return {
        "image/height": [anno["height"]],
        "image/width": [anno["width"]],
        "image/depth": [anno.get("depth", 3)],
        "image/object/bbox/xmin": xmins,
        "image/object/bbox/ymin": ymins,
        "image/object/bbox/xmax": xmaxs,
        "image/object/bbox/ymax": ymaxs,
        "image/object/class/label": ids,
        "image/object/class/text": texts,
        "image/encoded": [content],
        "image/filename": [anno["filename"].encode()],
    }


# -- COCO -----------------------------------------------------------------

def coco_annotations(instances_json: str, images_dir: str) -> List[dict]:
    """COCO instances JSON -> per-image grouped annos
    (Datasets/MSCOCO/tfrecords.py:135+). Category ids are remapped to a dense
    0..C-1 range sorted by original id (COCO ids have holes)."""
    with open(instances_json) as f:
        coco = json.load(f)
    cat_ids = sorted(c["id"] for c in coco["categories"])
    cat_index = {cid: i for i, cid in enumerate(cat_ids)}
    cat_name = {c["id"]: c["name"] for c in coco["categories"]}
    by_image: Dict[int, List[dict]] = {}
    for a in coco.get("annotations", []):
        if a.get("iscrowd"):
            continue
        by_image.setdefault(a["image_id"], []).append(a)
    annos = []
    for img in coco["images"]:
        boxes = []
        for a in by_image.get(img["id"], ()):
            x, y, bw, bh = a["bbox"]  # COCO xywh absolute
            boxes.append(
                {
                    "class_id": cat_index[a["category_id"]],
                    "class_text": cat_name[a["category_id"]],
                    "xmin": x,
                    "ymin": y,
                    "xmax": x + bw,
                    "ymax": y + bh,
                }
            )
        annos.append(
            {
                "filename": img["file_name"],
                "filepath": os.path.join(images_dir, img["file_name"]),
                "width": img["width"],
                "height": img["height"],
                "depth": 3,
                "bboxes": boxes,
            }
        )
    return annos


# -- ImageNet -------------------------------------------------------------

def imagenet_annotations(root: str, synsets_path: str) -> List[dict]:
    """Flattened `nXXXXXXXX_*.JPEG` folder -> annotations with 1-based labels
    (0 reserved for background, build_imagenet_tfrecord.py convention).
    The reference's `bbox_csv` option, which attaches boxes per filename,
    waits for the bbox-CSV converter."""
    with open(synsets_path) as f:
        synsets = [line.strip().split()[0] for line in f if line.strip()]
    label_of = {s: i + 1 for i, s in enumerate(synsets)}
    annos = []
    for name in sorted(os.listdir(root)):
        if not name.lower().endswith((".jpeg", ".jpg", ".png")):
            continue
        synset = name.split("_")[0]
        annos.append(
            {
                "filename": name,
                "filepath": os.path.join(root, name),
                "synset": synset,
                "label": label_of[synset],
            }
        )
    return annos


def imagenet_example(anno: dict) -> Optional[dict]:
    """Colorspace/synset/label Example (build_imagenet_tfrecord.py:184+);
    non-JPEG/non-RGB inputs (PNG, CMYK jpegs) are re-encoded to RGB JPEG so
    the stamped format/colorspace metadata is truthful — the reference's
    PNG/CMYK fixups (:256-308)."""
    import io

    from PIL import Image

    with open(anno["filepath"], "rb") as f:
        content = f.read()
    img = Image.open(io.BytesIO(content))
    if img.format != "JPEG" or img.mode != "RGB":
        buf = io.BytesIO()
        img.convert("RGB").save(buf, format="JPEG", quality=95)
        content = buf.getvalue()
    ex = {
        "image/colorspace": [b"RGB"],
        "image/channels": [3],
        "image/class/label": [anno["label"]],
        "image/class/synset": [anno["synset"].encode()],
        "image/format": [b"JPEG"],
        "image/filename": [anno["filename"].encode()],
        "image/encoded": [content],
    }
    return ex


# -- MPII -----------------------------------------------------------------

def mpii_annotations(json_path: str, images_dir: str) -> List[dict]:
    """Preprocessed MPII train/validation.json (a list of people:
    `image`, `joints` [[x, y]] * 16 in pixels, `joints_vis`, optional
    `center` and `scale`), the input Datasets/MPII/tfrecords_mpii.py
    reads."""
    with open(json_path) as f:
        people = json.load(f)
    return [{"filename": p["image"],
             "filepath": os.path.join(images_dir, p["image"]),
             "joints": p["joints"], "joints_vis": p["joints_vis"],
             # the person scale (x 200 px = body height) drives CropRoi;
             # optional in older preprocessed jsons
             "center": p.get("center"), "scale": p.get("scale")}
            for p in people]


def mpii_example(anno: dict) -> Optional[dict]:
    """Keypoint Example (tfrecords_mpii.py:65-84): x and y normalised by
    the decoded image's width and height, the visibility, the person
    scale and, normalised, its centre where the annotation has them."""
    from deep_vision_tpu_torch.data.datasets import decode_image

    with open(anno["filepath"], "rb") as f:
        content = f.read()
    h, w = decode_image(content).shape[:2]
    ex = {
        "image/height": [h],
        "image/width": [w],
        "image/person/keypoints/x": [float(j[0]) / w for j in anno["joints"]],
        "image/person/keypoints/y": [float(j[1]) / h for j in anno["joints"]],
        "image/person/keypoints/visibility": [int(v) for v in
                                              anno["joints_vis"]],
        "image/encoded": [content],
        "image/filename": [anno["filename"].encode()],
    }
    if anno.get("scale") is not None:
        ex["image/person/scale"] = [float(anno["scale"])]
    if anno.get("center") is not None:
        cx, cy = anno["center"]
        ex["image/person/center/x"] = [float(cx) / w]
        ex["image/person/center/y"] = [float(cy) / h]
    return ex


# -- CycleGAN ---------------------------------------------------------------

def cyclegan_examples(images_dir: str) -> List[dict]:
    """Image-only annotations for one domain folder, sorted by name
    (CycleGAN/tensorflow/tfrecords.py): .jpg, .jpeg and .png files."""
    return [{"filepath": os.path.join(images_dir, n), "filename": n}
            for n in sorted(os.listdir(images_dir))
            if n.lower().endswith((".jpg", ".jpeg", ".png"))]


def image_only_example(anno: dict) -> Optional[dict]:
    """The file's bytes as they are, and its name."""
    with open(anno["filepath"], "rb") as f:
        content = f.read()
    return {"image/encoded": [content],
            "image/filename": [anno["filename"].encode()]}
