"""The training state, the port of deep_vision_tpu/core/train_state.py.

The reference keeps one functional pytree `{step, params, batch_stats,
opt_state, rng}`. Here the model owns its parameters and BatchNorm
running statistics (buffers), the optimizer owns its momentum, and the
state bundles them with the step counter and the generator that per-step
randomness (dropout, augmentation) draws from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from deep_vision_tpu_torch.core.backend import DeviceLike, resolve_device


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


def create_train_state(model: nn.Module,
                       tx: Callable[[nn.Module], torch.optim.Optimizer],
                       sample_input: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       device: DeviceLike = None) -> TrainState:
    """Move `model` to `device` (default cuda), build the optimizer `tx`
    over its parameters, and run `sample_input` through it once in eval
    mode without gradients, as the reference's `model.init` does: a model
    that does not take the input fails here, not at the first step.
    `generator` defaults to one on the device seeded with 0."""
    dev = resolve_device(device)
    model = model.to(dev)
    was_training = model.training
    with torch.no_grad():
        model.eval()(torch.as_tensor(sample_input).to(dev))
    model.train(was_training)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return TrainState(step=0, model=model, optimizer=tx(model),
                      generator=generator)
