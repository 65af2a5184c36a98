"""Dataset -> sharded record conversion, the port of
deep_vision_tpu/tools/converters.py: the VOC, COCO, MPII, ImageNet and
CycleGAN converters, with the reference's field names, so shards
interoperate both ways, written through the port's `RecordWriter`, and
the steps before them that write no records (ImageNet's bbox CSV and
flattened layout, the CelebA domain split).

- VOC: XML parse and a normalized-bbox Example (Datasets/VOC2007/
  tfrecords.py:38-95, 124-155), splits from ImageSets/Main (:163-175).
- COCO: instances JSON -> per-image annotations with dense category ids
  (Datasets/MSCOCO/tfrecords.py:135+), the same Example.
- ImageNet: the synset label from the flattened file name and a label
  Example (Datasets/ILSVRC2012/build_imagenet_tfrecord.py:184+), with
  the boxes of a bbox CSV where one is given; the CSV from the bbox
  XMLs (process_bounding_boxes.py) and the flattened train/val layout
  from the raw download (untar-script.sh, flatten-script.sh,
  flatten-val-script.sh).
- MPII: a preprocessed people JSON -> keypoint Examples
  (Datasets/MPII/tfrecords_mpii.py:65-84).
- CycleGAN: a domain folder's images -> image-only Examples, and
  CelebA split into trainA/trainB by a binary attribute
  (CycleGAN/tensorflow/celeba.py).

Shards are written by `multiprocessing.Pool` workers started with
`spawn` (forking a process that runs threads can deadlock), one shard a
chunk.
"""
from __future__ import annotations

import csv
import glob
import json
import multiprocessing as mp
import os
import re
import shutil
import tarfile
import xml.etree.ElementTree as ET
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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

def imagenet_bbox_csv(xml_dir: str, out_csv: str,
                      synsets_path: Optional[str] = None) -> dict:
    """ImageNet bbox XMLs -> one CSV line per box: `file,xmin,ymin,xmax,ymax`
    (Datasets/ILSVRC2012/process_bounding_boxes.py).

    Walks `<xml_dir>/nXXXXXXXX/nXXXXXXXX_YYYY.xml` (or a flat dir of
    XMLs), normalises each pixel box by the annotator's displayed <size>
    (not the downloadable image's, hence relative coordinates), clamps to
    [0, 1], swaps inverted min/max and, with `synsets_path`, keeps the
    challenge synsets only. A malformed XML is counted and skipped.
    Returns the counters of the reference's summary.
    """
    keep = None
    if synsets_path:
        with open(synsets_path) as f:
            keep = {line.strip().split()[0] for line in f if line.strip()}
    xmls = sorted(glob.glob(os.path.join(xml_dir, "*", "*.xml"))
                  + glob.glob(os.path.join(xml_dir, "*.xml")))
    n_files = n_boxes = n_skipped_files = n_skipped_boxes = 0
    n_malformed = 0
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as out:
        w = csv.writer(out)
        for path in xmls:
            n_files += 1
            synset = os.path.basename(path).split("_")[0]
            if keep is not None and synset not in keep:
                n_skipped_files += 1
                continue
            try:
                root = ET.parse(path).getroot()
                size = root.find("size")
                width = float(size.findtext("width"))
                height = float(size.findtext("height"))
                if width <= 0 or height <= 0:
                    raise ValueError(f"degenerate size {width}x{height}")
                # an XML without <filename> is named after its image
                fname = (root.findtext("filename")
                         or os.path.splitext(os.path.basename(path))[0])
                if not fname.lower().endswith((".jpeg", ".jpg")):
                    fname += ".JPEG"
                rows = []
                for obj in root.iter("object"):
                    name = obj.findtext("name")
                    if keep is not None and name not in keep:
                        n_skipped_boxes += 1
                        continue
                    bb = obj.find("bndbox")
                    x1 = min(max(float(bb.findtext("xmin")) / width, 0.0), 1.0)
                    y1 = min(max(float(bb.findtext("ymin")) / height, 0.0), 1.0)
                    x2 = min(max(float(bb.findtext("xmax")) / width, 0.0), 1.0)
                    y2 = min(max(float(bb.findtext("ymax")) / height, 0.0), 1.0)
                    if x1 > x2:  # an inverted human annotation
                        x1, x2 = x2, x1
                    if y1 > y2:
                        y1, y2 = y2, y1
                    rows.append([fname, f"{x1:.4f}", f"{y1:.4f}",
                                 f"{x2:.4f}", f"{y2:.4f}"])
            except Exception as e:
                n_malformed += 1
                print(f"imagenet_bbox_csv: skipping malformed {path}: "
                      f"{type(e).__name__}: {e}")
                continue
            for row in rows:
                w.writerow(row)
                n_boxes += 1
    return {"files": n_files, "boxes": n_boxes,
            "skipped_files": n_skipped_files,
            "skipped_boxes": n_skipped_boxes,
            "malformed_files": n_malformed}


def load_bbox_csv(csv_path: str) -> dict:
    """A CSV from `imagenet_bbox_csv` -> {file stem: [[x1, y1, x2, y2],
    ...]}, keyed on the stem so that .jpg/.png files on disk match the
    CSV's .JPEG names."""
    boxes = defaultdict(list)
    with open(csv_path, newline="") as f:
        for row in csv.reader(f):
            if len(row) != 5:
                continue
            boxes[os.path.splitext(row[0])[0]].append(
                [float(v) for v in row[1:]])
    return dict(boxes)


def _place(src: str, dst: str, move: bool) -> None:
    """Hardlink (same filesystem, no extra disk), else copy; or move."""
    if move:
        shutil.move(src, dst)
        return
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def prepare_imagenet(out_dir: str,
                     train_tars: Optional[str] = None,
                     train_dir: Optional[str] = None,
                     val_dir: Optional[str] = None,
                     val_synsets: Optional[str] = None,
                     move: bool = False) -> Dict[str, int]:
    """The raw ILSVRC2012 download -> the flattened layout that
    `imagenet_annotations` reads (untar-script.sh, flatten-script.sh and
    flatten-val-script.sh, without their second copy on disk).

    - `train_tars`: a directory of per-synset `nXXXXXXXX.tar` files,
      whose `nXXXXXXXX_*.JPEG` members extract straight into
      `<out_dir>/train_flatten/`;
    - `train_dir`: or an untarred tree of per-synset folders, whose files
      are hardlinked (moved with `move=True`) into `train_flatten/`;
    - `val_dir` with `val_synsets`: the flat `ILSVRC2012_val_*.JPEG`
      folder and imagenet_2012_validation_synset_labels.txt (line i =
      the synset of image i + 1); files land in `<out_dir>/val_flatten/`
      as `<synset>_<name>`, paired by the index parsed from each name.

    Returns the files a split; existing destinations are kept.
    """
    stats = {"train": 0, "val": 0}
    if train_tars or train_dir:
        tdst = os.path.join(out_dir, "train_flatten")
        os.makedirs(tdst, exist_ok=True)
    if train_tars:
        for t in sorted(t for t in os.listdir(train_tars)
                        if t.endswith(".tar")):
            with tarfile.open(os.path.join(train_tars, t)) as tf:
                for m in tf.getmembers():
                    if not m.isfile():
                        continue
                    dst = os.path.join(tdst, os.path.basename(m.name))
                    if not os.path.exists(dst):
                        with tf.extractfile(m) as src, open(dst, "wb") as f:
                            shutil.copyfileobj(src, f)
                    stats["train"] += 1
    if train_dir:
        for synset in sorted(os.listdir(train_dir)):
            sdir = os.path.join(train_dir, synset)
            if not os.path.isdir(sdir):
                continue
            for name in sorted(os.listdir(sdir)):
                dst = os.path.join(tdst, name)
                if not os.path.exists(dst):
                    _place(os.path.join(sdir, name), dst, move)
                stats["train"] += 1
    if val_dir:
        if not val_synsets:
            raise ValueError(
                "val_dir requires val_synsets "
                "(imagenet_2012_validation_synset_labels.txt)")
        with open(val_synsets) as f:
            labels = [line.strip() for line in f if line.strip()]
        vdst = os.path.join(out_dir, "val_flatten")
        os.makedirs(vdst, exist_ok=True)
        names = [n for n in os.listdir(val_dir)
                 if n.lower().endswith((".jpeg", ".jpg", ".png"))]

        # paired by the parsed index, never by name order: a renamed file
        # would shift every later label while the counts still agree
        def val_index(name: str) -> int:
            m = re.match(r"ILSVRC2012_val_(\d{8})\.", name)
            if not m:
                raise ValueError(
                    f"unrecognized validation image name {name!r} in "
                    f"{val_dir}: expected ILSVRC2012_val_NNNNNNNN.<ext>; "
                    "refusing to pair images with synset labels")
            return int(m.group(1))

        names.sort(key=val_index)
        if len(names) != len(labels):
            raise ValueError(
                f"{len(names)} val images but {len(labels)} synset labels")
        for i, name in enumerate(names):
            if val_index(name) != i + 1:
                raise ValueError(
                    f"validation set has a gap: expected index {i + 1}, "
                    f"found {name!r} — labels would misalign from here on")
        for name, synset in zip(names, labels):
            dst = os.path.join(vdst, f"{synset}_{name}")
            if not os.path.exists(dst):
                _place(os.path.join(val_dir, name), dst, move)
            stats["val"] += 1
    return stats


def imagenet_annotations(root: str, synsets_path: str,
                         bbox_csv: Optional[str] = None) -> List[dict]:
    """Flattened `nXXXXXXXX_*.JPEG` folder -> annotations with 1-based labels
    (0 reserved for background, build_imagenet_tfrecord.py convention).
    With `bbox_csv` (from imagenet_bbox_csv), each file's boxes attach by
    its stem and land in the Example's image/object/bbox/* fields."""
    with open(synsets_path) as f:
        synsets = [line.strip().split()[0] for line in f if line.strip()]
    label_of = {s: i + 1 for i, s in enumerate(synsets)}
    boxes_of = load_bbox_csv(bbox_csv) if bbox_csv else {}
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
                "bboxes": boxes_of.get(os.path.splitext(name)[0], []),
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
    # the boxes of a bbox CSV (build_imagenet_tfrecord.py:184-254): min
    # and max lists and the image's label once a box; the classifiers'
    # read path ignores them
    if anno.get("bboxes"):
        bbs = anno["bboxes"]
        ex["image/object/bbox/xmin"] = [float(b[0]) for b in bbs]
        ex["image/object/bbox/ymin"] = [float(b[1]) for b in bbs]
        ex["image/object/bbox/xmax"] = [float(b[2]) for b in bbs]
        ex["image/object/bbox/ymax"] = [float(b[3]) for b in bbs]
        ex["image/object/bbox/label"] = [anno["label"]] * len(bbs)
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


def celeba_split(attr_file: str, images_dir: str, out_dir: str,
                 attribute: str = "Male", copy: bool = True
                 ) -> Tuple[int, int]:
    """Split CelebA into trainA/trainB domain folders by a binary
    attribute, looked up by name in list_attr_celeba.txt's header
    (CycleGAN/tensorflow/celeba.py, which hardcodes the gender column's
    byte offsets): +1 -> trainA, -1 -> trainB. Rows whose image is
    missing are skipped; none found raises. -> (n_trainA, n_trainB)."""
    with open(attr_file) as fp:
        fp.readline()  # line 1: the image count
        names = fp.readline().split()  # line 2: the attribute names
        if attribute not in names:
            raise ValueError(f"attribute {attribute!r} not in {names}")
        col = names.index(attribute)
        rows = [line.split() for line in fp if line.strip()]

    dir_a = os.path.join(out_dir, "trainA")
    dir_b = os.path.join(out_dir, "trainB")
    os.makedirs(dir_a, exist_ok=True)
    os.makedirs(dir_b, exist_ok=True)
    counts = [0, 0]
    n_skipped = 0
    for row in rows:
        filename, flags = row[0], row[1:]
        value = int(flags[col])
        if value not in (-1, 1):
            raise ValueError(f"bad attribute value {value} for {filename}")
        src = os.path.join(images_dir, filename)
        if not os.path.exists(src):
            n_skipped += 1
            continue
        dst_dir = dir_a if value == 1 else dir_b
        if copy:
            shutil.copyfile(src, os.path.join(dst_dir, filename))
        counts[0 if value == 1 else 1] += 1
    if rows and not (counts[0] or counts[1]):
        raise FileNotFoundError(
            f"none of the {len(rows)} listed images exist under "
            f"{images_dir!r} — wrong --images-dir?")
    if n_skipped:
        print(f"celeba_split: skipped {n_skipped} rows with missing images")
    return counts[0], counts[1]
