"""ObjectsAsPoints (CenterNet), the port of
deep_vision_tpu/models/centernet.py (:28-120).

NHWC images (B, 512, 512, 3) in; out, per stack, a dict of NHWC raw
heads at a quarter of the input: 'heatmap' (B, H/4, W/4, num_classes)
logits, 'wh' and 'offset' (B, H/4, W/4, 2). The backbone is a stride-2
7x7 stem (BatchNorm, then ReLU), an `HgBottleneck` to `features`, a 2x2
max pool and another bottleneck; then `num_stack` order-5
`CenterHourglassModule`s whose widths follow the fixed `_CURR_DIMS`
table (256, 256, 384, 384, 384, 512) whatever `features` is, each
followed by a bottleneck and a `DetectionHead` (3x3 256 conv, ReLU, 1x1
per branch; the heatmap branch's bias starts at -2.19, the focal-loss
prior -log((1 - 0.1) / 0.1)), and a 1x1 merge into the next stack's
input. It reuses the Hourglass port's pre-activation `HgBottleneck`, so
every BatchNorm's statistics run through the moments kernels. Children
carry the flax auto-names.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.models.hourglass import HgBottleneck, Named
from deep_vision_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    max_pool,
    reset_flax_parameters,
    upsample_nearest2x,
)

#: per-depth channel table (model.py:17-32 of the reference's source)
_CURR_DIMS = (256, 256, 384, 384, 384, 512)
#: the heatmap branch's initial bias
HEATMAP_BIAS = -2.19


class CenterHourglassModule(Named):
    def __init__(self, order: int):
        super().__init__()
        curr = _CURR_DIMS[5 - order]
        nxt = _CURR_DIMS[5 - order + 1]
        self.up = [self.add(HgBottleneck(curr, curr)),
                   self.add(HgBottleneck(curr, curr))]
        self.low = [self.add(HgBottleneck(curr, nxt)),
                    self.add(HgBottleneck(nxt, nxt))]
        self.low.append(self.add(CenterHourglassModule(order - 1))
                        if order > 1 else self.add(HgBottleneck(nxt, nxt)))
        self.low += [self.add(HgBottleneck(nxt, curr)),
                     self.add(HgBottleneck(curr, curr))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.up[1](self.up[0](x))
        low = max_pool(x, 2, 2)
        for m in self.low:
            low = m(low)
        return up + upsample_nearest2x(low)


class DetectionHead(Named):
    """3x3 conv + ReLU + 1x1 conv per branch: heatmap, wh, offset."""

    BRANCHES = ("heatmap", "wh", "offset")

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.branches = [
            (self.add(Conv(in_features, 256, 3)),
             self.add(Conv(256, ch, 1, bias_init=bias)))
            for ch, bias in ((num_classes, HEATMAP_BIAS), (2, 0.0), (2, 0.0))]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: out(F.relu(conv(x))).permute(0, 2, 3, 1)
                for name, (conv, out) in zip(self.BRANCHES, self.branches)}


class ObjectsAsPoints(Named):
    """NHWC images -> [{'heatmap', 'wh', 'offset'}] * num_stack."""

    def __init__(self, num_classes: int = 20, num_stack: int = 2,
                 features: int = 256, in_features: int = 3):
        super().__init__()
        f = features
        self.stem = (self.add(Conv(in_features, 128, 7, 2, use_bias=False)),
                     self.add(BatchNorm(128)),
                     self.add(HgBottleneck(128, f)),
                     self.add(HgBottleneck(f, f)))
        self.stacks = []
        for stack in range(num_stack):
            parts = [self.add(CenterHourglassModule(5)),
                     self.add(HgBottleneck(_CURR_DIMS[0], f)),
                     self.add(DetectionHead(f, num_classes))]
            if stack < num_stack - 1:
                parts.append(self.add(Conv(f, f, 1, use_bias=False)))
            self.stacks.append(parts)

    def forward(self, images: torch.Tensor
                ) -> List[Dict[str, torch.Tensor]]:
        conv, bn, first, second = self.stem
        x = F.relu(bn(conv(images.permute(0, 3, 1, 2))))
        x = second(max_pool(first(x), 2, 2))
        outputs = []
        for hg, bottleneck, head, *merge in self.stacks:
            inter = bottleneck(hg(x))
            outputs.append(head(inter))
            if merge:
                x = x + merge[0](inter)
        return outputs


@register_model("objects_as_points", init=reset_flax_parameters)
def objects_as_points(num_classes: int = 20, num_stack: int = 2, **_):
    return ObjectsAsPoints(num_classes=num_classes, num_stack=num_stack)
