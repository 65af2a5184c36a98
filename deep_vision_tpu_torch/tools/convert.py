"""Offline dataset -> sharded record conversion, the port of
deep_vision_tpu/tools/convert.py for VOC, COCO and ImageNet:

    python -m deep_vision_tpu_torch.tools.convert voc --voc-root R \\
        --split train|val|trainval|test --out-dir D [--num-shards 15]
    python -m deep_vision_tpu_torch.tools.convert coco --instances-json J \\
        --images-dir I --out-dir D [--prefix train] [--num-shards 64]
    python -m deep_vision_tpu_torch.tools.convert mpii --json J \\
        --images-dir I --out-dir D [--prefix train] [--num-shards 16]
    python -m deep_vision_tpu_torch.tools.convert imagenet --root R \\
        --synsets S --out-dir D [--prefix train] [--num-shards 1024]
    python -m deep_vision_tpu_torch.tools.convert cyclegan --images-dir I \\
        --out-dir D [--prefix trainA]

Each subcommand takes `--workers N` (default: one process a shard, at
most one a core). Shards are named `{prefix}_{i:04d}_of_{n:04d}.tfrecord`
(VOC: the split is the prefix), which `train_cli`'s records configs
read as `D/train*` and `D/val*`; cyclegan writes one shard a domain
folder. The reference's celeba, prepare-imagenet and imagenet_bboxes
subcommands are not ported yet.
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

    cyc = sub.add_parser("cyclegan", help="image folder -> one record file")
    cyc.add_argument("--images-dir", required=True)
    cyc.add_argument("--out-dir", required=True)
    cyc.add_argument("--prefix", default="trainA")

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
        annos = C.imagenet_annotations(args.root, args.synsets)
        C.build_shards(annos, C.imagenet_example, args.out_dir, args.prefix,
                       args.num_shards, num_workers=args.workers)
    else:
        annos = C.cyclegan_examples(args.images_dir)
        C.build_shards(annos, C.image_only_example, args.out_dir,
                       args.prefix, num_shards=1, num_workers=args.workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
