"""Batch-shape bucketing (a copy of deep_vision_tpu/serve/buckets.py).

Coalesced requests round UP to the smallest warmed bucket, the tail rows
are zero-padded, and the padded rows are sliced off before anyone sees
them. Every predictor here is batch-independent (per-image decode and
NMS), so padding rows cannot perturb real rows. Host-side numpy only.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

#: default batch-size menu; powers of two keep the warmup cost log(max)
DEFAULT_BUCKETS = (1, 2, 4, 8)


def normalize_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """Sorted unique positive bucket sizes; an empty or invalid menu
    raises."""
    out = sorted({int(b) for b in buckets})
    if not out or out[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds the largest bucket."""
    for b in buckets:
        if b >= n:
            return int(b)
    return None


def pad_batch(images: List[np.ndarray], bucket: int,
              dtype=np.float32) -> np.ndarray:
    """Stack per-request images into (bucket, *image_shape), zero-padding
    rows [len(images), bucket). All images must share one shape."""
    if not images:
        raise ValueError("pad_batch on an empty request list")
    if len(images) > bucket:
        raise ValueError(f"{len(images)} requests do not fit bucket {bucket}")
    shape = images[0].shape
    for im in images[1:]:
        if im.shape != shape:
            raise ValueError(
                f"mixed image shapes in one batch: {im.shape} vs {shape}")
    out = np.zeros((bucket,) + tuple(shape), dtype=dtype)
    for i, im in enumerate(images):
        out[i] = im
    return out


def split_rows(tree: dict, n: int) -> List[dict]:
    """Batched output dict of (bucket, ...) host arrays -> one dict per
    real request, padded rows discarded, no batch dim."""
    keys = list(tree)
    return [{k: tree[k][i] for k in keys} for i in range(n)]
