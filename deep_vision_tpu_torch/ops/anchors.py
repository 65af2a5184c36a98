"""YOLO anchor constants (deep_vision_tpu/ops/anchors.py:19-26).

Anchor assignment belongs to training and is ported with it.
"""
from __future__ import annotations

import numpy as np

# COCO anchors normalized by 416; rows: (w, h)
YOLO_ANCHORS = np.array(
    [(10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
     (116, 90), (156, 198), (373, 326)],
    np.float32,
) / 416.0
# scale 0 = stride 32 (large objects) gets anchors 6,7,8, etc.
YOLO_ANCHOR_MASKS = np.array([[6, 7, 8], [3, 4, 5], [0, 1, 2]])
