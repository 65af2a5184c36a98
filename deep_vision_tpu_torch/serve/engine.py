"""Inference engine: every (model, bucket) shape runs once at startup
(the port of deep_vision_tpu/serve/engine.py).

PyTorch runs eagerly, so there is no executable to compile ahead; what
warmup buys here is that every batch shape has been through the device
once (cuDNN algorithm choice, allocator pools, the NMS kernel's build and
load) before the first user request, and the bucket menu is closed:
`run()` refuses a shape that was not warmed, as the JAX engine refuses
to compile at request time.

Variables are a runtime argument of the registered fn (a state_dict on
the engine's device), so `set_variables` swaps weights of the same
shapes with no re-warm, and `clone_with_variables` makes a shadow engine
over the same warmed menu.

Each (model, bucket) warmup runs under a `serve/warmup` span
(obs/trace.py). The executable cache and the perf-attribution hooks of
the JAX engine have no counterpart yet.
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from deep_vision_tpu_torch.core.backend import (
    DeviceLike,
    resolve_device,
    synchronize,
)
from deep_vision_tpu_torch.obs.registry import get_registry
from deep_vision_tpu_torch.obs.trace import span
from deep_vision_tpu_torch.serve.buckets import (
    DEFAULT_BUCKETS,
    normalize_buckets,
)


class ServeError(RuntimeError):
    """Serving contract violation (unwarmed bucket, unknown model, bad
    request shape)."""


class ModelEntry:
    """One registered model: the raw predict fn + its static serving menu."""

    __slots__ = ("name", "fn", "variables", "input_shape", "dtype", "buckets")

    def __init__(self, name: str, fn, variables: Dict[str, torch.Tensor],
                 input_shape: Tuple[int, ...], dtype,
                 buckets: Tuple[int, ...]):
        self.name = name
        self.fn = fn  # (variables, images) -> dict of batched tensors
        self.variables = variables
        self.input_shape = tuple(int(d) for d in input_shape)
        self.dtype = np.dtype(dtype)
        self.buckets = buckets


class Engine:
    """Multi-model serving menu over one device.

        eng = Engine()                       # cuda; Engine(device="cpu")
        eng.register("yolo", yolo_predict_fn(model), model.state_dict(),
                     input_shape=(416, 416, 3), buckets=(1, 2, 4, 8))
        eng.warmup()                         # every (model, bucket) once
        out = eng.run("yolo", images)        # images.shape[0] is a bucket
    """

    def __init__(self, device: DeviceLike = None, registry=None):
        self.device = resolve_device(device)
        self._entries: Dict[str, ModelEntry] = {}
        self._warm: set = set()
        self._warmed = False
        self._registry = registry or get_registry()
        self._g_warmed = self._registry.gauge(
            "serve_warmed_buckets", "(model, bucket) shapes warmed")

    # -- registration --------------------------------------------------------

    def _on_device(self, variables: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in variables.items()}

    def register(self, name: str, fn, variables: Mapping[str, torch.Tensor],
                 input_shape: Sequence[int],
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype=np.float32) -> ModelEntry:
        if self._warmed:
            raise ServeError(
                f"register({name!r}) after warmup: the bucket menu is "
                "closed once warmed (restart to change it)")
        if name in self._entries:
            raise ServeError(f"model {name!r} already registered")
        entry = ModelEntry(name, fn, self._on_device(variables),
                           tuple(input_shape), dtype,
                           normalize_buckets(buckets))
        self._entries[name] = entry
        return entry

    @property
    def models(self) -> Tuple[str, ...]:
        return tuple(self._entries)

    def entry(self, name: str) -> ModelEntry:
        e = self._entries.get(name)
        if e is None:
            raise ServeError(
                f"unknown model {name!r}; registered: {sorted(self._entries)}")
        return e

    # -- warmup --------------------------------------------------------------

    def warmup(self) -> dict:
        """Run every (model, bucket) shape once on the device, on zeros;
        returns {models, pairs, warmup_ms_total, detail}."""
        if not self._entries:
            raise ServeError("warmup() with no registered models")
        pairs = []
        for entry in self._entries.values():
            for bucket in entry.buckets:
                images = torch.from_numpy(np.zeros(
                    (bucket,) + entry.input_shape, entry.dtype))
                t0 = time.perf_counter()
                with span("serve/warmup", model=entry.name, bucket=bucket):
                    entry.fn(entry.variables, images.to(self.device))
                    synchronize(self.device)
                ms = (time.perf_counter() - t0) * 1e3
                self._warm.add((entry.name, bucket))
                pairs.append({"model": entry.name, "bucket": bucket,
                              "warmup_ms": ms})
        self._warmed = True
        self._g_warmed.set(len(self._warm))
        return {"models": len(self._entries), "pairs": len(pairs),
                "warmup_ms_total": sum(p["warmup_ms"] for p in pairs),
                "detail": pairs}

    @property
    def warmed(self) -> bool:
        return self._warmed

    def warmed_buckets(self, name: str) -> Tuple[int, ...]:
        return tuple(sorted(b for (n, b) in self._warm if n == name))

    # -- weight swap ---------------------------------------------------------

    @staticmethod
    def _check_like(name: str, old: Mapping[str, torch.Tensor],
                    new: Mapping[str, torch.Tensor]) -> None:
        """Swap variables must have the serving ones' keys, and per key
        the same shape and dtype: then the swap needs no re-warm."""
        if set(old) != set(new):
            missing, extra = sorted(set(old) - set(new)), \
                sorted(set(new) - set(old))
            raise ServeError(
                f"swap variables for {name!r} change the variable set "
                f"(missing {missing[:3]}, extra {extra[:3]}); a structural "
                "change needs a re-warm, not a hot swap")
        for k, o in old.items():
            n = new[k]
            if tuple(o.shape) != tuple(n.shape) or o.dtype != n.dtype:
                raise ServeError(
                    f"swap variables for {name!r} change {k!r} "
                    f"({tuple(n.shape)}/{n.dtype} vs "
                    f"{tuple(o.shape)}/{o.dtype}); shape/dtype changes "
                    "need a re-warm, not a hot swap")

    def set_variables(self, name: str,
                      variables: Mapping[str, torch.Tensor]) -> None:
        """Hot-swap `name`'s weights; takes effect at the next batch."""
        entry = self.entry(name)
        self._check_like(name, entry.variables, variables)
        entry.variables = self._on_device(variables)

    def clone_with_variables(self, variables_by_model) -> "Engine":
        """A shadow engine over the same warmed menu, with new weights for
        the named models; the others keep the serving weights."""
        if not self._warmed:
            raise ServeError("clone_with_variables() before warmup(): "
                             "there is no warmed menu to share yet")
        for name in variables_by_model:
            self._check_like(name, self.entry(name).variables,
                             variables_by_model[name])
        clone = Engine.__new__(Engine)
        clone.device = self.device
        clone._warm = self._warm  # shared, read-only on this path
        clone._warmed = True
        clone._registry = self._registry
        clone._g_warmed = self._g_warmed
        clone._entries = {}
        for name, entry in self._entries.items():
            variables = (self._on_device(variables_by_model[name])
                         if name in variables_by_model else entry.variables)
            clone._entries[name] = ModelEntry(
                name, entry.fn, variables, entry.input_shape, entry.dtype,
                entry.buckets)
        return clone

    # -- the request path ----------------------------------------------------

    def run(self, name: str, images) -> Dict[str, torch.Tensor]:
        """Run one padded batch; images (numpy or tensor) must be exactly
        (bucket, *input_shape) for a warmed bucket. Returns the fn's
        output on the device, without waiting for it."""
        if (name, int(images.shape[0])) not in self._warm:
            entry = self.entry(name)  # raises the clearer error first
            raise ServeError(
                f"model {name!r} has no warmed bucket {images.shape[0]} "
                f"(warmed: {list(self.warmed_buckets(name))}, menu: "
                f"{entry.buckets}); fix the bucket menu and re-warm")
        entry = self.entry(name)
        if tuple(images.shape[1:]) != entry.input_shape:
            raise ServeError(f"batch shape {tuple(images.shape)} does not "
                             f"match {name!r} input {entry.input_shape}")
        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        return entry.fn(entry.variables, x)
