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
(obs/trace.py) and adds one to the process-wide
`serve_warmup_pairs_total` (`warmup_count()`): with the kernel builds of
ops/cuda/build.py it is the port's counterpart of the JAX engine's
compile counter, which a weight swap must leave unchanged.

`Engine(excache=)` attaches a core/excache.ExecutableCache to the
process (core/build.py `attach_cache`): the libraries the warm-up loads
come from the cache, and a miss is compiled into it. The warm-up report
carries the reference's `backend_compiles` and `cache_hits`, here the
compiler runs and cache loads of this process during the warm-up (a
library loads once a process, so a second engine's warm-up reports
neither). The perf-attribution hook of the JAX engine's warm-up
(perfwatch) has no counterpart yet.

Variables may hold int8 leaves (serve/quantize.py): a key whose value is
`{"q8": int8 tensor, "scale": float32 tensor}`. They move to the device
as the rest, and a swap keeps each leaf's kind: a re-quantized tree of
the same shapes swaps with no warm-up, an int8 -> float32 swap (or the
reverse) is refused.

A registered fn may hold module state (`functional_call` swaps the
module's parameters for the call), so the calls of one fn are
serialised by its entry's `serve.model` lock, which a clone shares with
the fn.
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from deep_vision_tpu_torch.core import build
from deep_vision_tpu_torch.core.backend import (
    DeviceLike,
    resolve_device,
    synchronize,
)
from deep_vision_tpu_torch.obs import locksmith
from deep_vision_tpu_torch.obs.registry import get_registry
from deep_vision_tpu_torch.obs.trace import span
from deep_vision_tpu_torch.serve.buckets import (
    DEFAULT_BUCKETS,
    normalize_buckets,
)


def _warmups():
    return get_registry().counter(
        "serve_warmup_pairs_total",
        "(model, bucket) warm-ups run by any Engine in this process")


def warmup_count() -> int:
    """(model, bucket) warm-ups run by any Engine in this process."""
    return int(_warmups().value)


def _parts(key: str, value) -> Dict[str, torch.Tensor]:
    """A variable's tensors by path: the tensor itself, or an int8
    leaf's `<key>/q8` and `<key>/scale`."""
    if isinstance(value, Mapping):
        return {f"{key}/{q}": t for q, t in value.items()}
    return {key: value}


def _kind(value) -> str:
    return ("an int8 leaf" if isinstance(value, Mapping)
            else f"a {value.dtype} tensor")


class ServeError(RuntimeError):
    """Serving contract violation (unwarmed bucket, unknown model, bad
    request shape)."""


class ModelEntry:
    """One registered model: the raw predict fn + its static serving menu."""

    __slots__ = ("name", "fn", "variables", "input_shape", "dtype", "buckets",
                 "lock")

    def __init__(self, name: str, fn, variables: Dict[str, torch.Tensor],
                 input_shape: Tuple[int, ...], dtype,
                 buckets: Tuple[int, ...], lock=None):
        self.name = name
        # (variables, images) -> batched tensors: a dict, a tuple or one
        self.fn = fn
        self.variables = variables
        self.input_shape = tuple(int(d) for d in input_shape)
        self.dtype = np.dtype(dtype)
        self.buckets = buckets
        self.lock = lock if lock is not None else locksmith.lock(
            "serve.model")


class Engine:
    """Multi-model serving menu over one device.

        eng = Engine()                       # cuda; Engine(device="cpu")
        eng.register("yolo", yolo_predict_fn(model), model.state_dict(),
                     input_shape=(416, 416, 3), buckets=(1, 2, 4, 8))
        eng.warmup()                         # every (model, bucket) once
        out = eng.run("yolo", images)        # images.shape[0] is a bucket
    """

    def __init__(self, device: DeviceLike = None, registry=None,
                 excache=None):
        self.device = resolve_device(device)
        # one cache a process: attaching another root raises here
        self.excache = (build.attach_cache(excache) if excache is not None
                        else None)
        self._entries: Dict[str, ModelEntry] = {}
        self._warm: set = set()
        self._warmed = False
        self._registry = registry or get_registry()
        self._g_warmed = self._registry.gauge(
            "serve_warmed_buckets", "(model, bucket) shapes warmed")

    # -- registration --------------------------------------------------------

    def _on_device(self, variables: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """The variables on the engine's device; an int8 leaf's q8 and
        scale move together."""
        return {k: ({q: t.to(self.device) for q, t in v.items()}
                    if isinstance(v, Mapping) else v.to(self.device))
                for k, v in variables.items()}

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
        returns {models, pairs, warmup_ms_total, backend_compiles,
        cache_hits, detail}: the compiler runs and executable-cache loads
        of this process during the warm-up."""
        if not self._entries:
            raise ServeError("warmup() with no registered models")
        builds, loads = build.build_count(), build.cache_load_count()
        pairs = []
        for entry in self._entries.values():
            for bucket in entry.buckets:
                images = torch.from_numpy(np.zeros(
                    (bucket,) + entry.input_shape, entry.dtype))
                t0 = time.perf_counter()
                with span("serve/warmup", model=entry.name, bucket=bucket), \
                        entry.lock:
                    entry.fn(entry.variables, images.to(self.device))
                    synchronize(self.device)
                ms = (time.perf_counter() - t0) * 1e3
                _warmups().inc()
                self._warm.add((entry.name, bucket))
                pairs.append({"model": entry.name, "bucket": bucket,
                              "warmup_ms": ms})
        self._warmed = True
        self._g_warmed.set(len(self._warm))
        return {"models": len(self._entries), "pairs": len(pairs),
                "warmup_ms_total": sum(p["warmup_ms"] for p in pairs),
                "backend_compiles": build.build_count() - builds,
                "cache_hits": build.cache_load_count() - loads,
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
        the same kind (a tensor, or an int8 leaf's q8 and scale), shapes
        and dtypes: then the swap needs no re-warm."""
        if set(old) != set(new):
            missing, extra = sorted(set(old) - set(new)), \
                sorted(set(new) - set(old))
            raise ServeError(
                f"swap variables for {name!r} change the variable set "
                f"(missing {missing[:3]}, extra {extra[:3]}); a structural "
                "change needs a re-warm, not a hot swap")
        for k, o in old.items():
            n = new[k]
            if isinstance(o, Mapping) != isinstance(n, Mapping):
                raise ServeError(
                    f"swap variables for {name!r} change {k!r} to "
                    f"{_kind(n)} from {_kind(o)}; a change of precision "
                    "needs a re-warm, not a hot swap")
            old_parts, new_parts = _parts(k, o), _parts(k, n)
            if set(old_parts) != set(new_parts):
                raise ServeError(
                    f"swap variables for {name!r} change the parts of "
                    f"{k!r} ({sorted(new_parts)} vs {sorted(old_parts)}); "
                    "a structural change needs a re-warm, not a hot swap")
            for path, ot in old_parts.items():
                nt = new_parts[path]
                if tuple(ot.shape) != tuple(nt.shape) or \
                        ot.dtype != nt.dtype:
                    raise ServeError(
                        f"swap variables for {name!r} change {path!r} "
                        f"({tuple(nt.shape)}/{nt.dtype} vs "
                        f"{tuple(ot.shape)}/{ot.dtype}); shape/dtype "
                        "changes need a re-warm, not a hot swap")

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
        clone.excache = self.excache
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
                entry.buckets, lock=entry.lock)
        return clone

    # -- the request path ----------------------------------------------------

    def run(self, name: str, images):
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
        with entry.lock:
            return entry.fn(entry.variables, x)
