"""Model registry, the port of deep_vision_tpu/models/__init__.py.

Only the models of the ported slices are registered: `yolov3` and its
backbone `darknet53`. `get_model` returns the model in eval mode on the
resolved device, its weights drawn as flax draws them, from a
`torch.Generator` seeded with `seed` (the draws differ from JAX's; load
the reference's numbers through convert.py where they must agree).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, *, device: DeviceLike = None, seed: int = 0,
              **kwargs) -> torch.nn.Module:
    """Build `name` on `device` (default: cuda, raising without a card),
    with seeded random weights, in eval mode."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    model = MODEL_REGISTRY[name](**kwargs)
    yolov3.reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)


# importing the modules populates the registry
from deep_vision_tpu_torch.models import yolov3  # noqa: E402
