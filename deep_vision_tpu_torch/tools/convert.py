"""Offline dataset -> sharded record conversion, the port of
deep_vision_tpu/tools/convert.py for VOC, COCO and ImageNet:

    python -m deep_vision_tpu_torch.tools.convert voc --voc-root R \\
        --split train|val|trainval|test --out-dir D [--num-shards 15]
    python -m deep_vision_tpu_torch.tools.convert coco --instances-json J \\
        --images-dir I --out-dir D [--prefix train] [--num-shards 64]
    python -m deep_vision_tpu_torch.tools.convert mpii --json J \\
        --images-dir I --out-dir D [--prefix train] [--num-shards 16]
    python -m deep_vision_tpu_torch.tools.convert imagenet --root R \\
        --synsets S --out-dir D [--prefix train] [--num-shards 1024] \\
        [--bbox-csv CSV]
    python -m deep_vision_tpu_torch.tools.convert prepare-imagenet \\
        --out-dir D [--train-tars T | --train-dir T] \\
        [--val-dir V --val-synsets S] [--move]
    python -m deep_vision_tpu_torch.tools.convert imagenet_bboxes \\
        --xml-dir X --out-csv CSV [--synsets S]
    python -m deep_vision_tpu_torch.tools.convert cyclegan --images-dir I \\
        --out-dir D [--prefix trainA]
    python -m deep_vision_tpu_torch.tools.convert celeba --attr-file A \\
        --images-dir I --out-dir D [--attribute Male]

The record subcommands take `--workers N` (default: one process a
shard, at most one a core). Shards are named
`{prefix}_{i:04d}_of_{n:04d}.tfrecord` (VOC: the split is the prefix),
which `train_cli`'s records configs read as `D/train*` and `D/val*`;
cyclegan writes one shard a domain folder. prepare-imagenet writes
D/train_flatten and D/val_flatten for `imagenet --root`, imagenet_bboxes
the CSV for `--bbox-csv`, and celeba the trainA/trainB folders for
`cyclegan --images-dir`.
"""
from __future__ import annotations

import argparse

from deep_vision_tpu_torch.tools import converters as C


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="dataset", required=True)

    voc = sub.add_parser("voc", help="VOCdevkit/VOC2007|2012 -> records")
    voc.add_argument("--voc-root", required=True)
    voc.add_argument("--split", default="train",
                     choices=["train", "val", "trainval", "test"])
    voc.add_argument("--out-dir", required=True)
    # VOC2007/tfrecords.py:15-18: 15 train / 5 val shards
    voc.add_argument("--num-shards", type=int, default=15)

    coco = sub.add_parser("coco", help="MSCOCO instances json -> records")
    coco.add_argument("--instances-json", required=True)
    coco.add_argument("--images-dir", required=True)
    coco.add_argument("--out-dir", required=True)
    coco.add_argument("--prefix", default="train")
    # MSCOCO/tfrecords.py:13-14: 64 train / 8 val shards
    coco.add_argument("--num-shards", type=int, default=64)

    mpii = sub.add_parser("mpii", help="MPII preprocessed json -> records")
    mpii.add_argument("--json", required=True)
    mpii.add_argument("--images-dir", required=True)
    mpii.add_argument("--out-dir", required=True)
    mpii.add_argument("--prefix", default="train")
    mpii.add_argument("--num-shards", type=int, default=16)

    imagenet = sub.add_parser("imagenet", help="flattened ImageNet -> records")
    imagenet.add_argument("--root", required=True)
    imagenet.add_argument("--synsets", required=True)
    imagenet.add_argument("--out-dir", required=True)
    imagenet.add_argument("--prefix", default="train")
    # build_imagenet_tfrecord.py:104-160: 1024 train / 128 val shards
    imagenet.add_argument("--num-shards", type=int, default=1024)
    imagenet.add_argument("--bbox-csv", default=None,
                          help="CSV from `imagenet_bboxes`; attaches "
                               "image/object/bbox/* fields per filename")

    prep = sub.add_parser(
        "prepare-imagenet",
        help="raw ILSVRC2012 download -> flattened train/val layout "
             "(untar-script.sh + flatten-script.sh + flatten-val-script.sh "
             "analog)")
    prep.add_argument("--out-dir", required=True)
    prep.add_argument("--train-tars", default=None,
                      help="dir of per-synset nXXXXXXXX.tar files")
    prep.add_argument("--train-dir", default=None,
                      help="already-untarred per-synset tree")
    prep.add_argument("--val-dir", default=None,
                      help="flat ILSVRC2012_val_*.JPEG folder")
    prep.add_argument("--val-synsets", default=None,
                      help="imagenet_2012_validation_synset_labels.txt")
    prep.add_argument("--move", action="store_true",
                      help="move instead of hardlink/copy")

    inbb = sub.add_parser(
        "imagenet_bboxes",
        help="ImageNet bbox XMLs -> relative-coords CSV "
             "(process_bounding_boxes.py analog)")
    inbb.add_argument("--xml-dir", required=True)
    inbb.add_argument("--out-csv", required=True)
    inbb.add_argument("--synsets", default=None,
                      help="restrict to challenge synsets (one id per line)")

    cyc = sub.add_parser("cyclegan", help="image folder -> one record file")
    cyc.add_argument("--images-dir", required=True)
    cyc.add_argument("--out-dir", required=True)
    cyc.add_argument("--prefix", default="trainA")

    celeba = sub.add_parser(
        "celeba", help="CelebA attribute -> trainA/trainB domain split")
    celeba.add_argument("--attr-file", required=True,
                        help="path to list_attr_celeba.txt")
    celeba.add_argument("--images-dir", required=True)
    celeba.add_argument("--out-dir", required=True)
    celeba.add_argument("--attribute", default="Male",
                        help="any of the 40 CelebA attribute names")

    for sp in (voc, coco, mpii, imagenet, cyc):
        sp.add_argument("--workers", type=int, default=None)
    args = p.parse_args(argv)

    if args.dataset == "voc":
        annos = C.voc_annotations(args.voc_root, args.split)
        C.build_shards(annos, C.detection_example, args.out_dir, args.split,
                       args.num_shards, num_workers=args.workers)
    elif args.dataset == "coco":
        annos = C.coco_annotations(args.instances_json, args.images_dir)
        C.build_shards(annos, C.detection_example, args.out_dir, args.prefix,
                       args.num_shards, num_workers=args.workers)
    elif args.dataset == "mpii":
        annos = C.mpii_annotations(args.json, args.images_dir)
        C.build_shards(annos, C.mpii_example, args.out_dir, args.prefix,
                       args.num_shards, num_workers=args.workers)
    elif args.dataset == "imagenet":
        annos = C.imagenet_annotations(args.root, args.synsets,
                                       bbox_csv=args.bbox_csv)
        C.build_shards(annos, C.imagenet_example, args.out_dir, args.prefix,
                       args.num_shards, num_workers=args.workers)
    elif args.dataset == "prepare-imagenet":
        stats = C.prepare_imagenet(
            args.out_dir, train_tars=args.train_tars,
            train_dir=args.train_dir, val_dir=args.val_dir,
            val_synsets=args.val_synsets, move=args.move)
        parts = []
        if args.train_tars or args.train_dir:
            parts.append(f"{stats['train']} train -> "
                         f"{args.out_dir}/train_flatten")
        if args.val_dir:
            parts.append(f"{stats['val']} val -> {args.out_dir}/val_flatten")
        print("prepare-imagenet: " + ", ".join(parts))
    elif args.dataset == "imagenet_bboxes":
        stats = C.imagenet_bbox_csv(args.xml_dir, args.out_csv, args.synsets)
        annotated = (stats["files"] - stats["skipped_files"]
                     - stats["malformed_files"])
        print(f"Finished processing {stats['files']} XML files.\n"
              f"Skipped {stats['skipped_files']} XML files not in ImageNet "
              f"Challenge.\n"
              f"Skipped {stats['skipped_boxes']} bounding boxes not in "
              f"ImageNet Challenge.\n"
              f"Skipped {stats['malformed_files']} malformed XML files.\n"
              f"Wrote {stats['boxes']} bounding boxes from "
              f"{annotated} annotated images.")
    elif args.dataset == "cyclegan":
        annos = C.cyclegan_examples(args.images_dir)
        C.build_shards(annos, C.image_only_example, args.out_dir,
                       args.prefix, num_shards=1, num_workers=args.workers)
    else:
        n_a, n_b = C.celeba_split(args.attr_file, args.images_dir,
                                  args.out_dir, args.attribute)
        print(f"celeba: {n_a} -> trainA, {n_b} -> trainB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
