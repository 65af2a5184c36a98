"""Host-side numpy image transforms (the reference's hand-written set).

Parity targets — the deliberately hand-written transform classes at
ResNet/pytorch/data_load.py:72-296 (Rescale, RandomHorizontalFlip, RandomCrop,
CenterCrop, ToTensor, Normalize, ColorJitter), the TF "ResNet preprocessing"
(ResNet/tensorflow/data_load.py:158-193: aspect resize, central crop, mean
subtraction), and the bbox-preserving detection augments at
YOLO/tensorflow/preprocess.py:37-119.

All transforms are `__call__(sample: dict, rng) -> dict` over
{'image': HWC uint8/float numpy, 'label'/'boxes'/...}. They run on host CPU
workers; the device boundary is the Trainer's `_place_one`. Layout stays
HWC (NHWC batches, which the port's models take channels_last); the
reference's CHW ToTensor (data_load.py:176-194) has no analog here by design.

A copy of deep_vision_tpu/data/transforms.py, with one change: the image
library behind the resizes is imported when a resize first runs, cv2
first, else PIL, as the reference chooses them at import, so this module
imports on a machine that has neither.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np

# ImageNet channel stats (Normalize at ResNet/pytorch/train.py:327-329 uses
# torchvision's 0-1 stats; the TF path uses 0-255 means data_load.py:35-38)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# TF "ResNet preprocessing" 0-255 RGB means (ResNet/tensorflow/data_load.py:35-38)
TF_IMAGENET_MEAN = np.array([123.68, 116.78, 103.94], np.float32)


@functools.lru_cache(maxsize=None)
def _image_library():
    """("cv2", cv2) when cv2 imports, else ("PIL", PIL.Image); raises
    ImportError naming both when neither does."""
    try:
        import cv2

        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image

        return "PIL", Image
    except ImportError:
        raise ImportError(
            "resizing an image needs cv2 (opencv-python) or PIL (Pillow), "
            "and neither imports") from None


def _resize(image: np.ndarray, h: int, w: int) -> np.ndarray:
    name, lib = _image_library()
    if name == "cv2":
        out = lib.resize(image, (w, h), interpolation=lib.INTER_LINEAR)
        if out.ndim == 2:  # cv2 drops the channel dim for single-channel
            out = out[:, :, None]
        return out
    Image = lib
    pil = Image.fromarray(image.squeeze().astype(np.uint8))
    out = np.asarray(pil.resize((w, h), Image.BILINEAR))
    if out.ndim == 2:
        out = out[:, :, None]
    return out


class Rescale:
    """Aspect-preserving resize: shorter side -> `size`
    (ResNet/pytorch/data_load.py:72-101; _aspect_preserving_resize at
    ResNet/tensorflow/data_load.py:123-137)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image = sample["image"]
        h, w = image.shape[:2]
        if h < w:
            nh, nw = self.size, max(1, round(w * self.size / h))
        else:
            nh, nw = max(1, round(h * self.size / w)), self.size
        sample["image"] = _resize(image, nh, nw)
        return sample


class Resize:
    """Fixed-size (square) resize — YOLO 416 input (preprocess.py:24-27)."""

    def __init__(self, height: int, width: Optional[int] = None):
        self.h, self.w = height, width or height

    def __call__(self, sample: dict, rng) -> dict:
        image = sample["image"]
        sample["image"] = _resize(image, self.h, self.w)
        # normalized box coords are resize-invariant; nothing else to fix
        return sample


class RandomCrop:
    """Random fixed-size crop (ResNet/pytorch/data_load.py:116-143)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image = sample["image"]
        h, w = image.shape[:2]
        top = int(rng.integers(0, h - self.size + 1))
        left = int(rng.integers(0, w - self.size + 1))
        sample["image"] = image[top:top + self.size, left:left + self.size]
        return sample


class CenterCrop:
    """Center crop (ResNet/pytorch/data_load.py:146-173; _central_crop at
    ResNet/tensorflow/data_load.py:46-63)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, sample: dict, rng) -> dict:
        image = sample["image"]
        h, w = image.shape[:2]
        top = (h - self.size) // 2
        left = (w - self.size) // 2
        sample["image"] = image[top:top + self.size, left:left + self.size]
        return sample


# MPII joint order (0=r-ankle .. 9=head-top, 10=r-wrist .. 15=l-wrist):
# pairs whose identities exchange under a horizontal flip. The reference
# wrote a keypoint flip but disabled it with the comment "doesn't work with
# human pose estimation because it's orientation sensitive"
# (Hourglass/tensorflow/preprocess.py:31-40) — because it forgot exactly
# this swap: mirroring moves the LEFT ankle to where the RIGHT ankle's
# heatmap channel expects it. Swapping channel identities fixes that.
MPII_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))


class RandomHorizontalFlip:
    """p=0.5 flip (ResNet/pytorch/data_load.py:104-113). Flips normalized
    [x1,y1,x2,y2] 'boxes' too (random_flip_image_and_label,
    YOLO/tensorflow/preprocess.py:37-50).

    `keypoint_swap_pairs` (e.g. MPII_FLIP_PAIRS) additionally exchanges
    left/right joint identities — required for pose: without it a flip
    teaches every lateral channel the wrong side (the bug that made the
    reference disable its flip, preprocess.py:31-33)."""

    def __init__(self, p: float = 0.5,
                 keypoint_swap_pairs: Optional[Sequence] = None):
        self.p = p
        self.swap_pairs = keypoint_swap_pairs

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() >= self.p:
            return sample
        sample["image"] = sample["image"][:, ::-1]
        if "boxes" in sample and len(sample["boxes"]):
            b = np.array(sample["boxes"], np.float32)
            valid = b.any(axis=-1)  # all-zero rows are padding; leave them
            x1 = 1.0 - b[:, 2]
            x2 = 1.0 - b[:, 0]
            b[valid, 0], b[valid, 2] = x1[valid], x2[valid]
            sample["boxes"] = b
        if "keypoints" in sample and len(sample["keypoints"]):
            k = np.array(sample["keypoints"], np.float32)
            k[:, 0] = 1.0 - k[:, 0]
            if self.swap_pairs is not None:
                perm = np.arange(len(k))
                for a, b_ in self.swap_pairs:
                    perm[a], perm[b_] = b_, a
                k = k[perm]
                if "visibility" in sample:
                    sample["visibility"] = np.asarray(
                        sample["visibility"], np.float32
                    )[perm]
            sample["keypoints"] = k
        return sample


class CropRoi:
    """Keypoint-driven person crop for pose training
    (crop_roi, Hourglass/tensorflow/preprocess.py:43-88).

    The visible-keypoint extent, padded by `margin x body height`, is cut
    out before the square resize — so the person fills the frame instead of
    being a small figure in a wide shot. Body height comes from the MPII
    person 'scale' annotation (scale x 200 px, the MPII convention) when
    the sample carries it, else from the visible keypoint extent itself.

    `margin` may be a float (eval: the reference's fixed 0.2) or a (lo, hi)
    range sampled per image (train: the reference's U(0.1, 0.3) — its scale
    augmentation). Keypoints are remapped to crop-relative normalized
    coordinates, invisible (-1) joints ride along and land outside [0, 1],
    where the heatmap scatter already drops them (data/labels.py).
    """

    def __init__(self, margin=0.2):
        self.margin = margin

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image = sample["image"]
        h, w = image.shape[:2]
        kp = np.asarray(sample["keypoints"], np.float32)  # (J, 2) normalized
        vis = np.asarray(
            sample.get("visibility", np.ones((len(kp),))), np.float32
        )
        kx, ky = kp[:, 0] * w, kp[:, 1] * h
        visible = vis > 0
        if not visible.any():
            return sample  # nothing to anchor the crop on
        if isinstance(self.margin, (tuple, list)):
            margin = float(rng.uniform(self.margin[0], self.margin[1]))
        else:
            margin = float(self.margin)
        xmin, xmax = kx[visible].min(), kx[visible].max()
        ymin, ymax = ky[visible].min(), ky[visible].max()
        if sample.get("scale", 0) and float(sample["scale"]) > 0:
            body_h = float(sample["scale"]) * 200.0  # MPII scale convention
        else:  # scale 0.0 = unknown (older preprocessed jsons)
            body_h = max(ymax - ymin, 1.0)
        pad = margin * body_h
        # clamp the top-left INSIDE the image: keypoints may sit outside the
        # frame (unclamped annotations), and an x1 >= w would make the
        # x2 = x1+1 fixup produce an empty slice that kills Resize downstream
        x1 = min(max(int(xmin - pad), 0), w - 1)
        y1 = min(max(int(ymin - pad), 0), h - 1)
        x2 = min(int(xmax + pad), w)
        y2 = min(int(ymax + pad), h)
        x2, y2 = max(x2, x1 + 1), max(y2, y1 + 1)
        sample["image"] = image[y1:y2, x1:x2]
        nh, nw = y2 - y1, x2 - x1
        out = kp.copy()
        out[:, 0] = (kx - x1) / nw
        out[:, 1] = (ky - y1) / nh
        # a visible joint cropped out (tight margin) must not scatter a
        # wrong-position gaussian: the [0,1] range check downstream drops it
        sample["keypoints"] = out
        return sample


class RandomCropWithBoxes:
    """Bbox-preserving random crop: the crop window always contains every box
    (random_crop_image_and_label, YOLO/tensorflow/preprocess.py:79-119).

    Boxes are normalized [x1,y1,x2,y2]; rows of zeros are padding and ignored.
    """

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image = sample["image"]
        boxes = np.array(sample.get("boxes", ()), np.float32)
        h, w = image.shape[:2]
        valid = boxes.any(axis=-1) if len(boxes) else np.zeros((0,), bool)
        if valid.any():
            vb = boxes[valid]
            min_x1, min_y1 = vb[:, 0].min(), vb[:, 1].min()
            max_x2, max_y2 = vb[:, 2].max(), vb[:, 3].max()
        else:
            min_x1 = min_y1 = 1.0
            max_x2 = max_y2 = 0.0
        # sample crop edges outside the union of boxes
        left = rng.uniform(0.0, min(min_x1, 1.0))
        top = rng.uniform(0.0, min(min_y1, 1.0))
        right = rng.uniform(max(max_x2, 0.0), 1.0)
        bottom = rng.uniform(max(max_y2, 0.0), 1.0)
        x1p, y1p = int(left * w), int(top * h)
        x2p, y2p = max(int(right * w), x1p + 1), max(int(bottom * h), y1p + 1)
        sample["image"] = image[y1p:y2p, x1p:x2p]
        if len(boxes):
            nw, nh = (x2p - x1p) / w, (y2p - y1p) / h
            out = boxes.copy()
            out[valid, 0] = (boxes[valid, 0] - x1p / w) / nw
            out[valid, 2] = (boxes[valid, 2] - x1p / w) / nw
            out[valid, 1] = (boxes[valid, 1] - y1p / h) / nh
            out[valid, 3] = (boxes[valid, 3] - y1p / h) / nh
            sample["boxes"] = np.clip(out, 0.0, 1.0)
        return sample


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter
    (ResNet/pytorch/data_load.py:213-296, PIL-based there; vectorized here)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _factor(rng, amount):
        return float(rng.uniform(max(0.0, 1.0 - amount), 1.0 + amount))

    _LUMA = np.array([0.299, 0.587, 0.114], np.float32)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        was_uint8 = sample["image"].dtype == np.uint8
        img = sample["image"].astype(np.float32)
        if was_uint8 or img.max() > 1.5:  # uint8 range
            scale = 255.0
        else:
            scale = 1.0
        rgb = img.shape[-1] == 3
        # brightness (img *= fb), contrast ((img - m) fc + m with m the mean
        # luma), and saturation ((img - gray) fs + gray) are each affine in
        # (img, gray, 1) and luma is linear, so their composition folds into
        # ONE pass out = A*img + B*gray0 + C — the host pipeline is CPU-bound
        # (SURVEY §7 hard part #1) and the naive chain costs 3x the memory
        # traffic. Factor draws stay in the b, c, s order for seed parity
        # with the sequential implementation.
        fb = self._factor(rng, self.brightness) if self.brightness else 1.0
        fc = self._factor(rng, self.contrast) if self.contrast else 1.0
        fs = (
            self._factor(rng, self.saturation)
            if self.saturation and rgb
            else 1.0
        )
        if fc != 1.0 or fs != 1.0:
            gray0 = img[..., :3] @ self._LUMA if rgb else img[..., 0]
            m = fb * float(gray0.mean()) if fc != 1.0 else 0.0
            a = fb * fc * fs
            b_coef = (1.0 - fs) * fb * fc
            c = (1.0 - fc) * m
            img = a * img + (b_coef * gray0 + c)[..., None]
        elif fb != 1.0:
            img = fb * img
        if self.hue and rgb:
            # hue rotation in YIQ space (cheap, differentiable-free host op)
            theta = float(rng.uniform(-self.hue, self.hue)) * 2 * np.pi
            u, w_ = np.cos(theta), np.sin(theta)
            t = np.array(
                [
                    [0.299 + 0.701 * u + 0.168 * w_, 0.587 - 0.587 * u + 0.330 * w_, 0.114 - 0.114 * u - 0.497 * w_],
                    [0.299 - 0.299 * u - 0.328 * w_, 0.587 + 0.413 * u + 0.035 * w_, 0.114 - 0.114 * u + 0.292 * w_],
                    [0.299 - 0.300 * u + 1.250 * w_, 0.587 - 0.588 * u - 1.050 * w_, 0.114 + 0.886 * u - 0.203 * w_],
                ],
                np.float32,
            )
            img = img @ t.T
        img = np.clip(img, 0.0, scale)
        # preserve dtype so a later ToFloat still rescales 0-255 -> 0-1
        sample["image"] = img.astype(np.uint8) if was_uint8 else img
        return sample


class ToFloat:
    """uint8 [0,255] -> float32 [0,1]; grayscale stays single-channel
    unless `expand_gray_to_rgb` (ToTensor's 3-channel expand,
    ResNet/pytorch/data_load.py:176-194 — layout conversion dropped: NHWC).
    `scale=False` keeps the 0-255 range (the TF mean-subtraction chain
    normalizes on that scale, ResNet/tensorflow/data_load.py:158-193)."""

    def __init__(self, expand_gray_to_rgb: bool = False, scale: bool = True):
        self.expand = expand_gray_to_rgb
        self.scale = scale

    def __call__(self, sample: dict, rng) -> dict:
        img = sample["image"]
        if img.dtype == np.uint8 and self.scale:
            img = img.astype(np.float32) / 255.0
        else:
            img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        if self.expand and img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        sample["image"] = img
        return sample


class Normalize:
    """(x - mean) / std per channel (ResNet/pytorch/data_load.py:197-210)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: dict, rng) -> dict:
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


class ToFloatNormalize:
    """Fused ToFloat + Normalize: uint8 [0,255] -> (x/255 - mean) / std in
    ONE pass (x * 1/(255 std) - mean/std). The sequential pair costs two
    full-image float passes; the host pipeline is CPU-bound (SURVEY §7 hard
    part #1), so the fusion matters at ImageNet rates. Semantics match
    `ToFloat(expand_gray_to_rgb=e)` followed by `Normalize(mean, std)`.
    """

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 expand_gray_to_rgb: bool = False):
        std = np.asarray(std, np.float32)
        mean = np.asarray(mean, np.float32)
        self._scale_u8 = (1.0 / (255.0 * std)).astype(np.float32)
        self._scale_f = (1.0 / std).astype(np.float32)
        self._shift = (mean / std).astype(np.float32)
        self.expand = expand_gray_to_rgb

    def __call__(self, sample: dict, rng) -> dict:
        img = sample["image"]
        if img.ndim == 2:
            img = img[:, :, None]
        if self.expand and img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        scale = self._scale_u8 if img.dtype == np.uint8 else self._scale_f
        sample["image"] = img * scale - self._shift
        return sample


class MeanSubtract:
    """The TF "ResNet preprocessing" normalization variant: subtract per-
    channel means from a 0-255 image, no scaling (_mean_image_subtraction at
    ResNet/tensorflow/data_load.py:66-92; channel means 123.68/116.78/103.94
    at :35-38). Use instead of ToFloat+Normalize to reproduce the reference's
    TF training chain exactly."""

    def __init__(self, mean=None):
        self.mean = np.asarray(
            TF_IMAGENET_MEAN if mean is None else mean, np.float32
        )

    def __call__(self, sample: dict, rng) -> dict:
        img = sample["image"].astype(np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[-1] != self.mean.shape[0]:
            raise ValueError(
                f"image has {img.shape[-1]} channels, "
                f"mean has {self.mean.shape[0]}"
            )
        sample["image"] = img - self.mean
        return sample


class PadBoxes:
    """Pad/truncate 'boxes' (+aligned 'classes') to a fixed count — ragged ->
    static shapes for jit (the reference's TensorArray loops become masked
    scatters; max 100 boxes matches yolov3.py:452-454)."""

    def __init__(self, max_boxes: int = 100):
        self.max_boxes = max_boxes

    def __call__(self, sample: dict, rng) -> dict:
        boxes = np.array(sample.get("boxes", ()), np.float32).reshape(-1, 4)
        classes = np.array(sample.get("classes", ()), np.int32).reshape(-1)
        n = min(len(boxes), self.max_boxes)
        out_b = np.zeros((self.max_boxes, 4), np.float32)
        out_c = np.zeros((self.max_boxes,), np.int32)
        out_b[:n] = boxes[:n]
        out_c[:n] = classes[:n] if len(classes) else 0
        sample["boxes"] = out_b
        sample["classes"] = out_c
        return sample


def space_to_depth(image: np.ndarray, block: int = 2) -> np.ndarray:
    """(H, W, C) -> (H/b, W/b, b*b*C), channel order (dy, dx, c).

    The host half of the MLPerf-ResNet stem trick (models/resnet.py
    SpaceToDepthStem): laid out this way on the host, the 7x7/s2
    3-channel stem conv becomes a 4x4 conv over 12 channels.
    """
    h, w, c = image.shape
    assert h % block == 0 and w % block == 0, (h, w, block)
    out = image.reshape(h // block, block, w // block, block, c)
    return out.transpose(0, 2, 1, 3, 4).reshape(h // block, w // block,
                                                block * block * c)


class SpaceToDepth:
    """Pipeline transform: rewrite sample['image'] with `space_to_depth`."""

    def __init__(self, block: int = 2):
        self.block = block

    def __call__(self, sample: dict, rng) -> dict:
        sample["image"] = space_to_depth(np.asarray(sample["image"]), self.block)
        return sample
