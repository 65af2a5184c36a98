"""Inception V1 (GoogLeNet) and V3, the port of
deep_vision_tpu/models/inception.py (V1 :28-112 and :243, V3 :115-240
and :248).

NHWC images in. In training mode V1 returns `(logits, aux1, aux2)` and
V3 `(logits, aux)`; in eval mode the logits alone. The port's
`classification_loss_fn` adds each aux head's cross entropy at
`aux_weight` (0.3 in the inception1 config). Every conv is a
`BasicConv`: a bias-free conv with xavier_normal kernels (a truncated
normal on fan_avg), a BatchNorm without a fused act, then a ReLU; its
BatchNorm takes the unfused `(x - mean) * inv + bias` branch, as in the
reference, and launches no bn_act. The branches of a module concatenate
on channels; every tensor stays channels_last. The aux heads flatten in
the reference's NHWC order, so their shapes depend on `image_size`
(default the registered configs': 224 for V1, 299 for V3), as flax
infers them at init. Dropout 0.4 (V1) / 0.5 (V3) before the head and
0.7 in V1's aux heads.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models import register_model
from deep_vision_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    Dense,
    Dropout,
    Padding,
    avg_pool,
    flatten_nhwc,
    global_avg_pool,
    max_pool,
    reset_flax_parameters,
)

XAVIER = "xavier_normal"


def _valid(size: int, kernel: int = 3, stride: int = 2) -> int:
    return (size - kernel) // stride + 1


def _same(size: int, stride: int = 2) -> int:
    return -(-size // stride)


class BasicConv(nn.Module):
    """Conv (xavier, no bias) + BatchNorm + ReLU (inception.py:28-41)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Union[int, Tuple[int, int]],
                 strides: int = 1, padding: Padding = "SAME"):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           use_bias=False, kernel_init=XAVIER)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Branches(nn.Module):
    """A module whose `BasicConv_k` children are numbered in the order
    the reference constructs them."""

    def _convs(self, specs: Sequence[tuple]) -> None:
        for k, spec in enumerate(specs):
            setattr(self, f"BasicConv_{k}", BasicConv(*spec))

    def conv(self, k: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"BasicConv_{k}")(x)


class InceptionModule(_Branches):
    """1x1 / 1x1-3x3 / 1x1-5x5 / 3x3 max pool-1x1 (inception.py:44-63)."""

    def __init__(self, cin: int, c1: int, c3r: int, c3: int, c5r: int,
                 c5: int, cp: int):
        super().__init__()
        self.features = c1 + c3 + c5 + cp
        self._convs([(cin, c1, 1), (cin, c3r, 1), (c3r, c3, 3),
                     (cin, c5r, 1), (c5r, c5, 5), (cin, cp, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.conv(0, x), self.conv(2, self.conv(1, x)),
            self.conv(4, self.conv(3, x)),
            self.conv(5, max_pool(x, 3, 1, "SAME"))], dim=1)


class AuxClassifier(nn.Module):
    """V1's aux head on a `size` x `size` input (inception.py:66-76)."""

    def __init__(self, cin: int, num_classes: int, size: int):
        super().__init__()
        size = _valid(size, 5, 3)
        self.BasicConv_0 = BasicConv(cin, 128, 1)
        self.Dense_0 = Dense(size * size * 128, 1024, kernel_init=XAVIER)
        self.Dropout_0 = Dropout(0.7)
        self.Dense_1 = Dense(1024, num_classes, kernel_init=XAVIER)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = flatten_nhwc(self.BasicConv_0(avg_pool(x, 5, 3)))
        return self.Dense_1(self.Dropout_0(F.relu(self.Dense_0(x))))


#: InceptionModule widths (c1, c3r, c3, c5r, c5, cp): 3a, 3b | 4a-4e | 5a, 5b
V1_MODULES = ((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64),
              (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
              (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
              (256, 160, 320, 32, 128, 128), (256, 160, 320, 32, 128, 128),
              (384, 192, 384, 48, 128, 128))
#: V1's 3x3/2 max pools come after these modules; the aux heads after
V1_POOL_AFTER, V1_AUX_AFTER = (1, 6), (2, 5)


class InceptionV1(nn.Module):
    def __init__(self, num_classes: int = 1000, image_size: int = 224):
        super().__init__()
        self.BasicConv_0 = BasicConv(3, 64, 7, 2)
        self.BasicConv_1 = BasicConv(64, 64, 1)
        self.BasicConv_2 = BasicConv(64, 192, 3)
        size = _same(_same(_same(_same(image_size))))  # the 4a-4e grid
        prev = 192
        for i, widths in enumerate(V1_MODULES):
            module = InceptionModule(prev, *widths)
            setattr(self, f"InceptionModule_{i}", module)
            prev = module.features
            if i in V1_AUX_AFTER:
                setattr(self, f"AuxClassifier_{V1_AUX_AFTER.index(i)}",
                        AuxClassifier(prev, num_classes, size))
        self.Dropout_0 = Dropout(0.4)
        self.Dense_0 = Dense(prev, num_classes, kernel_init=XAVIER)

    def forward(self, images: torch.Tensor):
        x = self.BasicConv_0(images.permute(0, 3, 1, 2))
        x = max_pool(x, 3, 2, "SAME")
        x = self.BasicConv_2(self.BasicConv_1(x))
        x = max_pool(x, 3, 2, "SAME")
        aux = []
        for i in range(len(V1_MODULES)):
            x = getattr(self, f"InceptionModule_{i}")(x)
            if i in V1_POOL_AFTER:
                x = max_pool(x, 3, 2, "SAME")
            if i in V1_AUX_AFTER and self.training:
                aux.append(getattr(
                    self, f"AuxClassifier_{V1_AUX_AFTER.index(i)}")(x))
        logits = self.Dense_0(self.Dropout_0(global_avg_pool(x)))
        return (logits, *aux) if self.training else logits


class InceptionA(_Branches):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.features = 224 + pool_features
        self._convs([(cin, 64, 1), (cin, 48, 1), (48, 64, 5), (cin, 64, 1),
                     (64, 96, 3), (96, 96, 3), (cin, pool_features, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.conv(0, x), self.conv(2, self.conv(1, x)),
            self.conv(5, self.conv(4, self.conv(3, x))),
            self.conv(6, avg_pool(x, 3, 1, "SAME"))], dim=1)


class ReductionA(_Branches):
    def __init__(self, cin: int):
        super().__init__()
        self.features = 384 + 96 + cin
        self._convs([(cin, 384, 3, 2, "VALID"), (cin, 64, 1), (64, 96, 3),
                     (96, 96, 3, 2, "VALID")])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.conv(0, x), self.conv(3, self.conv(2, self.conv(1, x))),
            max_pool(x, 3, 2)], dim=1)


class InceptionB(_Branches):
    """The factorized 7x7 module."""

    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.features = 768
        self._convs([(cin, 192, 1), (cin, c7, 1), (c7, c7, (1, 7)),
                     (c7, 192, (7, 1)), (cin, c7, 1), (c7, c7, (7, 1)),
                     (c7, c7, (1, 7)), (c7, c7, (7, 1)), (c7, 192, (1, 7)),
                     (cin, 192, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = x
        for k in (1, 2, 3):
            b2 = self.conv(k, b2)
        b3 = x
        for k in (4, 5, 6, 7, 8):
            b3 = self.conv(k, b3)
        return torch.cat([self.conv(0, x), b2, b3,
                          self.conv(9, avg_pool(x, 3, 1, "SAME"))], dim=1)


class ReductionB(_Branches):
    def __init__(self, cin: int):
        super().__init__()
        self.features = 320 + 192 + cin
        self._convs([(cin, 192, 1), (192, 320, 3, 2, "VALID"), (cin, 192, 1),
                     (192, 192, (1, 7)), (192, 192, (7, 1)),
                     (192, 192, 3, 2, "VALID")])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = x
        for k in (2, 3, 4, 5):
            b2 = self.conv(k, b2)
        return torch.cat([self.conv(1, self.conv(0, x)), b2,
                          max_pool(x, 3, 2)], dim=1)


class InceptionC(_Branches):
    """The expanded-filter-bank output module."""

    def __init__(self, cin: int):
        super().__init__()
        self.features = 2048
        self._convs([(cin, 320, 1), (cin, 384, 1), (384, 384, (1, 3)),
                     (384, 384, (3, 1)), (cin, 448, 1), (448, 384, 3),
                     (384, 384, (1, 3)), (384, 384, (3, 1)), (cin, 192, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.conv(1, x)
        b3 = self.conv(5, self.conv(4, x))
        return torch.cat([
            self.conv(0, x), self.conv(2, b2), self.conv(3, b2),
            self.conv(6, b3), self.conv(7, b3),
            self.conv(8, avg_pool(x, 3, 1, "SAME"))], dim=1)


class InceptionV3Aux(nn.Module):
    """V3's aux head on a `size` x `size` input: its second conv spans the
    pooled grid (inception.py:205-213)."""

    def __init__(self, cin: int, num_classes: int, size: int):
        super().__init__()
        size = _valid(size, 5, 3)
        self.BasicConv_0 = BasicConv(cin, 128, 1)
        self.BasicConv_1 = BasicConv(128, 768, size, padding="VALID")
        self.Dense_0 = Dense(768, num_classes, kernel_init=XAVIER)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BasicConv_1(self.BasicConv_0(avg_pool(x, 5, 3)))
        return self.Dense_0(flatten_nhwc(x))


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000, image_size: int = 299):
        super().__init__()
        self.BasicConv_0 = BasicConv(3, 32, 3, 2, "VALID")
        self.BasicConv_1 = BasicConv(32, 32, 3, padding="VALID")
        self.BasicConv_2 = BasicConv(32, 64, 3)
        self.BasicConv_3 = BasicConv(64, 80, 1)
        self.BasicConv_4 = BasicConv(80, 192, 3, padding="VALID")
        # the InceptionA grid: 35 at 299
        size = _valid(_valid(_valid(image_size) - 2) - 2)
        blocks = ([InceptionA, 32], [InceptionA, 64], [InceptionA, 64],
                  [ReductionA], [InceptionB, 128], [InceptionB, 160],
                  [InceptionB, 160], [InceptionB, 192], [ReductionB],
                  [InceptionC], [InceptionC])
        counts, prev, self.block_names = {}, 192, []
        for cls, *args in blocks:
            name = f"{cls.__name__}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
            block = cls(prev, *args)
            setattr(self, name, block)
            self.block_names.append(name)
            prev = block.features
            if cls is ReductionA:
                size = _valid(size)  # the InceptionB grid
        self.InceptionV3Aux_0 = InceptionV3Aux(768, num_classes, size)
        self.Dropout_0 = Dropout(0.5)
        self.Dense_0 = Dense(prev, num_classes, kernel_init=XAVIER)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2)
        for k in range(3):
            x = getattr(self, f"BasicConv_{k}")(x)
        x = self.BasicConv_4(self.BasicConv_3(max_pool(x, 3, 2)))
        x = max_pool(x, 3, 2)
        aux = None
        for name in self.block_names:
            if name == "ReductionB_0" and self.training:
                aux = self.InceptionV3Aux_0(x)
            x = getattr(self, name)(x)
        logits = self.Dense_0(self.Dropout_0(global_avg_pool(x)))
        return (logits, aux) if self.training else logits


@register_model("inception1", init=reset_flax_parameters)
def inception_v1(num_classes: int = 1000, image_size: int = 224, **_):
    return InceptionV1(num_classes=num_classes, image_size=image_size)


@register_model("inception3", init=reset_flax_parameters)
def inception_v3(num_classes: int = 1000, image_size: int = 299, **_):
    return InceptionV3(num_classes=num_classes, image_size=image_size)
