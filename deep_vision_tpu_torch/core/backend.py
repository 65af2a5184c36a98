"""Device resolution: `cuda` by default, `cpu` only when asked.

The counterpart of deep_vision_tpu/core/backend.py. There, a platform
profile decides whether Pallas kernels compile or run interpreted. Here
the tensor's own device decides: a kernel wrapper takes its plain
PyTorch version for a CPU tensor and launches its CUDA kernel for a CUDA
tensor. So the only routing left is which device an entry point puts its
work on, and that never falls back quietly: asking for `cuda` on a
machine without a card raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None or "cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU. Any other device type is refused."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was asked for (the default) but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (cuda or cpu)")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
