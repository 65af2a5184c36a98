"""Model registry, the port of deep_vision_tpu/models/__init__.py.

Only the models of the ported slices are registered: `yolov3` and its
backbone `darknet53`; the classifiers `lenet5`, `alexnet1`, `alexnet2`,
`vgg16`, `vgg19`, `inception1`, `inception3`, `resnet34`, `resnet50`,
`resnet152`, `resnet50v2`, `mobilenet1` and `shufflenet1`; the dense
ViTs `vit_s16` and `vit_b16`, the V-MoE `vmoe_s16`; the GANs'
`dcgan_generator`, `dcgan_discriminator`, `cyclegan_generator` and
`cyclegan_discriminator`; the pose `hourglass` and CenterNet's
`objects_as_points`. Each registers with its own initialiser,
which draws the weights as flax draws them from a `torch.Generator`
seeded with `seed` (the draws differ from JAX's; load the reference's
numbers through convert.py where they must agree). `get_model` returns
the model on the resolved device, in eval mode unless `train=True`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device

Init = Callable[[torch.nn.Module, Optional[torch.Generator]], None]
MODEL_REGISTRY: Dict[str, Tuple[Callable, Init]] = {}


def register_model(name: str, *, init: Init):
    """Register a builder under `name`, with `init(model, generator)`,
    which (re)draws all of the model's weights."""
    def deco(fn):
        MODEL_REGISTRY[name] = (fn, init)
        return fn

    return deco


def get_model(name: str, *, device: DeviceLike = None, seed: int = 0,
              train: bool = False, **kwargs) -> torch.nn.Module:
    """Build `name` on `device` (default: cuda, raising without a card),
    with seeded random weights, in training mode if `train` else eval."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    build, init = MODEL_REGISTRY[name]
    model = build(**kwargs)
    init(model, torch.Generator().manual_seed(seed))
    return model.train(train).to(dev)


# importing the modules populates the registry
from deep_vision_tpu_torch.models import (  # noqa: E402,F401
    alexnet,
    centernet,
    cyclegan,
    dcgan,
    hourglass,
    inception,
    lenet,
    mobilenet,
    resnet,
    shufflenet,
    vgg,
    vit,
    yolov3,
)
