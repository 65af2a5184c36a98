"""Image-in, result-out inference for every task family, the port of
deep_vision_tpu/tools/infer.py:

    python -m deep_vision_tpu_torch.tools.infer -m resnet50 -c ck/ a.jpg b.jpg
    python -m deep_vision_tpu_torch.tools.infer -m yolov3_voc -c ck/ street.jpg
    python -m deep_vision_tpu_torch.tools.infer -m hourglass_mpii -c ck/ person.jpg
    python -m deep_vision_tpu_torch.tools.infer -m cyclegan -c ck/ photo.jpg -o out/
    python -m deep_vision_tpu_torch.tools.infer -m lenet5 --device cpu digit.png

Classification prints the top 5 (and with --render writes a
<name>_classified.jpg banner); detection and CenterNet print the NMS'd
or decoded boxes and write a <name>_boxes.txt sidecar and, where cv2
imports, a <name>_detected.jpg overlay; pose prints each joint's
(x, y, score) and, with cv2, writes <name>_pose.jpg; the GAN configs run
the generator and write <name>_generated.jpg. Outputs go beside the
inputs, or under -o.

`-c` takes a checkpoint directory that `train_cli` wrote: its newest
step's model state_dict is restored on the device. Without `-c` the
model keeps `get_model`'s seeded initialisation, with a warning. The
GAN trainers save their sub-networks under their own names, which this
restore does not read: `-c` with a GAN run raises KeyError, as the JAX
package's does. `--device` is cuda by default and raises without a
card; `--device cpu` runs every kernel's plain version.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from deep_vision_tpu_torch.core.backend import resolve_device


def _load_image(path: str, size: int, normalize: str, rescale: int = 0):
    """Decode and apply the eval chain training used for `normalize`:
    "imagenet" (torchvision stats), "imagenet_tf" (0-255 mean
    subtraction), "unit" ([0, 1]) or anything else ([-1, 1], the GANs).
    -> HWC float32."""
    from deep_vision_tpu_torch.data import transforms as T
    from deep_vision_tpu_torch.data.datasets import decode_image

    with open(path, "rb") as f:
        img = decode_image(f.read())
    sample = {"image": img}
    rng = np.random.default_rng(0)
    if normalize == "imagenet":
        chain = [T.Rescale(rescale or size + 32), T.CenterCrop(size),
                 T.ToFloatNormalize(expand_gray_to_rgb=True)]
    elif normalize == "imagenet_tf":
        chain = [T.Rescale(rescale or size + 32), T.CenterCrop(size),
                 T.ToFloat(expand_gray_to_rgb=True, scale=False),
                 T.MeanSubtract()]
    elif normalize == "unit":
        chain = [T.Resize(size), T.ToFloat(expand_gray_to_rgb=True)]
    else:
        chain = [T.Resize(size), T.ToFloat(expand_gray_to_rgb=True),
                 T.Normalize(mean=[0.5] * 3, std=[0.5] * 3)]
    for t in chain:
        sample = t(sample, rng)
    return sample["image"]


# MPII skeleton: limbs between joint indices (right leg, left leg, spine
# and head, right arm, left arm)
POSE_SKELETON = ((0, 1), (1, 2), (2, 6), (3, 6), (3, 4), (4, 5), (6, 7),
                 (7, 8), (8, 9), (10, 11), (11, 12), (12, 7), (13, 7),
                 (13, 14), (14, 15))
_PALETTE = ((255, 99, 71), (60, 179, 113), (65, 105, 225), (255, 215, 0),
            (186, 85, 211), (0, 206, 209), (255, 140, 0), (154, 205, 50))


def _write_jpeg(dst: str, rgb_u8: np.ndarray) -> None:
    """RGB uint8 -> a JPEG file, with cv2 where it imports, else PIL."""
    try:
        import cv2

        if not cv2.imwrite(dst, rgb_u8[..., ::-1]):  # RGB -> BGR for cv2
            raise IOError(f"cv2.imwrite returned False for {dst}")
    except Exception:  # cv2 may fail at load time with OSError
        from PIL import Image

        Image.fromarray(rgb_u8).save(dst, quality=95)


def _reload_rgb(path: str, size: int) -> np.ndarray:
    """The display copy: decoded and resized, not normalised."""
    from deep_vision_tpu_torch.data import transforms as T
    from deep_vision_tpu_torch.data.datasets import decode_image

    with open(path, "rb") as f:
        img = decode_image(f.read())
    s = T.Resize(size)({"image": img}, np.random.default_rng(0))
    return np.ascontiguousarray(s["image"][..., :3])


def draw_detections(image: np.ndarray, boxes, scores, classes,
                    class_names=None) -> np.ndarray:
    """Boxes and labels over an RGB uint8 image; boxes are normalised
    [x1, y1, x2, y2]. Needs cv2."""
    import cv2

    out = image.copy()
    h, w = out.shape[:2]
    for b, s, c in zip(boxes, scores, classes):
        color = _PALETTE[int(c) % len(_PALETTE)]
        x1, y1 = int(b[0] * w), int(b[1] * h)
        x2, y2 = int(b[2] * w), int(b[3] * h)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        name = (class_names[int(c)] if class_names
                and 0 <= int(c) < len(class_names) else f"class {int(c)}")
        label = f"{name} {float(s):.2f}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ty = y1 - 4 if y1 - th - 8 >= 0 else y2 + th + 4
        cv2.rectangle(out, (x1, ty - th - 4), (x1 + tw + 2, ty + 2), color, -1)
        cv2.putText(out, label, (x1 + 1, ty - 2), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (255, 255, 255), 1, cv2.LINE_AA)
    return out


def draw_classification(image: np.ndarray, label: str,
                        prob: float) -> np.ndarray:
    """A top-1 banner over an RGB uint8 image, drawn with PIL."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(image)
    d = ImageDraw.Draw(im, "RGBA")
    h = max(20, image.shape[0] // 14)
    d.rectangle([0, 0, image.shape[1], h], fill=(0, 0, 0, 190))
    d.text((8, max(3, h // 4)), f"{label}  {prob:.2f}",
           fill=(255, 255, 255, 255))
    return np.asarray(im)


def draw_pose(image: np.ndarray, kpts, score_threshold: float = 0.1,
              skeleton=POSE_SKELETON) -> np.ndarray:
    """Joint dots and skeleton limbs; kpts (J, 3) = normalised x, y and
    score. Needs cv2."""
    import cv2

    out = image.copy()
    h, w = out.shape[:2]
    pts = [(int(x * w), int(y * h)) if s >= score_threshold else None
           for x, y, s in np.asarray(kpts, np.float32)]
    for e, (a, b) in enumerate(skeleton):
        if a < len(pts) and b < len(pts) and pts[a] and pts[b]:
            cv2.line(out, pts[a], pts[b], _PALETTE[e % len(_PALETTE)], 2,
                     cv2.LINE_AA)
    for p in pts:
        if p:
            cv2.circle(out, p, 3, (255, 255, 255), -1, cv2.LINE_AA)
            cv2.circle(out, p, 3, (30, 30, 30), 1, cv2.LINE_AA)
    return out


def _restore_variables(model: torch.nn.Module, ckpt_dir: Optional[str],
                       device: torch.device) -> dict:
    """The newest checkpoint's state_dict on `device`, loaded into
    `model` (strictly: a checkpoint of another model raises); without
    `ckpt_dir`, the model's own seeded initialisation."""
    if not ckpt_dir:
        print("warning: no -c checkpoint; running with fresh-init weights")
        return model.state_dict()
    from deep_vision_tpu_torch.core.checkpoint import CheckpointManager

    variables = CheckpointManager(ckpt_dir).restore_variables(device=device)
    model.load_state_dict(variables)
    return variables


def main(argv: Optional[List[str]] = None) -> int:
    from deep_vision_tpu_torch.configs import CONFIG_REGISTRY, get_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", required=True,
                   choices=sorted(CONFIG_REGISTRY))
    p.add_argument("-c", "--checkpoint", default=None)
    p.add_argument("-o", "--output-dir", default=None,
                   help="GAN outputs / detection sidecars go here "
                        "(default: alongside inputs)")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--preprocessing", default="torch", choices=["torch", "tf"],
                   help="must match how the checkpoint was trained "
                        "(train_cli --preprocessing)")
    p.add_argument("--render", action="store_true",
                   help="classification configs: also write a "
                        "<name>_classified.jpg display copy with the top-1 "
                        "label drawn")
    p.add_argument("--labels", default=None,
                   help="class-name file, one name per line, line i = model "
                        "class index i (the converter's imagenet labels are "
                        "1-based with 0 = background)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default: the card)")
    p.add_argument("images", nargs="+")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from deep_vision_tpu_torch.models import get_model

    cfg = get_config(args.model)
    size = cfg.input_shape[0]

    # class names label classification (top-5 lines, --render banner)
    # and detection (printed lines, box overlays)
    names = None
    if args.labels:
        with open(args.labels) as fh:
            names = [line.strip() for line in fh if line.strip()]
    elif cfg.dataset.get("schema") == "voc":
        from deep_vision_tpu_torch.tools.converters import VOC_CLASSES

        names = list(VOC_CLASSES)

    def name_of(i: int) -> str:
        return names[i] if names and 0 <= i < len(names) else f"class {i}"

    def outpath(src: str, suffix: str) -> str:
        root, _ = os.path.splitext(os.path.basename(src))
        d = args.output_dir or os.path.dirname(src) or "."
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, root + suffix)

    def on_device(batch: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, np.float32), device=dev)

    if cfg.task == "classification":
        if cfg.dataset.get("kind") == "imagenet":
            mode = "imagenet_tf" if args.preprocessing == "tf" else "imagenet"
            batch = np.stack([
                _load_image(f, cfg.eval_crop, mode, rescale=cfg.train_resize)
                for f in args.images])
        else:
            # small-input configs (mnist-style): resized to input_shape,
            # and to grayscale with the mnist chain's stats where the
            # model takes one channel
            batch = np.stack([_load_image(f, size, "unit")
                              for f in args.images])
            if cfg.input_shape[2] == 1:
                luma = np.array([0.299, 0.587, 0.114], np.float32)
                batch = (batch @ luma)[..., None]
                batch = (batch - 0.1307) / 0.3081
        if cfg.model_kwargs.get("stem") == "s2d":
            from deep_vision_tpu_torch.data.transforms import space_to_depth

            batch = np.stack([space_to_depth(im) for im in batch])
        model = get_model(cfg.model, num_classes=cfg.num_classes,
                          device=dev, **cfg.model_kwargs)
        _restore_variables(model, args.checkpoint, dev)
        with torch.inference_mode():
            logits = model(on_device(batch)).float().cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        for f, pr in zip(args.images, probs):
            top = np.argsort(pr)[::-1][:5]
            picks = " ".join(f"{name_of(int(i))}: {pr[i]:.3f}" for i in top)
            print(f"{f}: {picks}")
            if args.render:
                k = int(top[0])
                drawn = draw_classification(
                    _reload_rgb(f, size), name_of(k), float(pr[k]))
                dst = outpath(f, "_classified.jpg")
                _write_jpeg(dst, drawn)
                print(f"  wrote {dst}")
        return 0

    if cfg.task in ("detection", "centernet"):
        from deep_vision_tpu_torch.inference import (
            make_centernet_detector,
            make_yolo_detector,
        )

        batch = np.stack([_load_image(f, size, "unit") for f in args.images])
        model = get_model(cfg.model, num_classes=cfg.num_classes,
                          device=dev, **cfg.model_kwargs)
        variables = _restore_variables(model, args.checkpoint, dev)
        make = (make_yolo_detector if cfg.task == "detection"
                else make_centernet_detector)
        detect = make(model, device=dev,
                      score_threshold=args.score_threshold)
        out = {k: v.cpu().numpy()
               for k, v in detect(variables, on_device(batch)).items()}
        try:  # overlays need cv2, which is optional everywhere
            import cv2
        except Exception:
            cv2 = None
            print("note: opencv not installed; skipping _detected.jpg "
                  "overlays (text sidecars still written)")
        for i, f in enumerate(args.images):
            n = int(out["num"][i])
            print(f"{f}: {n} detections")
            lines = []
            for j in range(n):
                b = out["boxes"][i, j]
                line = (f"  {name_of(int(out['classes'][i, j]))} "
                        f"score {float(out['scores'][i, j]):.3f} "
                        f"box [{b[0]:.3f} {b[1]:.3f} {b[2]:.3f} {b[3]:.3f}]")
                print(line)
                lines.append(line.strip())
            with open(outpath(f, "_boxes.txt"), "w") as fh:
                fh.write("\n".join(lines) + "\n")
            if cv2 is not None:
                drawn = draw_detections(
                    _reload_rgb(f, size), out["boxes"][i, :n],
                    out["scores"][i, :n], out["classes"][i, :n],
                    class_names=names)
                dst = outpath(f, "_detected.jpg")
                cv2.imwrite(dst, drawn[..., ::-1])  # RGB -> BGR
                print(f"  -> {dst}")
        return 0

    if cfg.task == "pose":
        from deep_vision_tpu_torch.inference import make_pose_estimator

        batch = np.stack([_load_image(f, size, "unit") for f in args.images])
        model = get_model(cfg.model, device=dev, **cfg.model_kwargs)
        variables = _restore_variables(model, args.checkpoint, dev)
        estimate = make_pose_estimator(model, device=dev)
        kpts = estimate(variables, on_device(batch)).cpu().numpy()
        try:
            import cv2
        except Exception:
            cv2 = None
            print("note: opencv not installed; skipping _pose.jpg overlays")
        for f, kp in zip(args.images, kpts):
            print(f"{f}:")
            for j, (x, y, s) in enumerate(kp):
                print(f"  joint {j}: x={x:.3f} y={y:.3f} score={s:.3f}")
            if cv2 is not None:
                drawn = draw_pose(_reload_rgb(f, size), kp)
                dst = outpath(f, "_pose.jpg")
                cv2.imwrite(dst, drawn[..., ::-1])
                print(f"  -> {dst}")
        return 0

    if cfg.task in ("dcgan", "cyclegan"):
        if cfg.task == "dcgan":
            model = get_model("dcgan_generator", device=dev)
            x = np.random.RandomState(0).randn(len(args.images), 100)
        else:
            model = get_model("cyclegan_generator", device=dev)
            x = np.stack([_load_image(f, size, "gan") for f in args.images])
        _restore_variables(model, args.checkpoint, dev)
        with torch.inference_mode():
            imgs = model(on_device(x)).float().cpu().numpy()
        for f, im in zip(args.images, imgs):
            u8 = np.clip((im + 1.0) * 127.5, 0, 255).astype(np.uint8)
            dst = outpath(f, "_generated.jpg")
            _write_jpeg(dst, u8)
            print(f"{f} -> {dst}")
        return 0

    raise ValueError(f"unsupported task {cfg.task!r}")


if __name__ == "__main__":
    raise SystemExit(main())
