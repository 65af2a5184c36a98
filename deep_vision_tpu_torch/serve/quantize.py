"""Int8 post-training quantization for the serving path (the port of
deep_vision_tpu/serve/quantize.py).

Conv and dense kernels are stored int8 with per-output-channel symmetric
scales and dequantized at every call (`q8.float() * scale`, feeding the
matmul or convolution in float32), so every accumulation stays float32:
weight-only PTQ. In the port the dequantized float32 weights are
materialised on every call, so int8 serving moves MORE bytes than
float32 serving, not fewer: the int8 tree read, the float32 copy
written and read. It saves the weights' resident and checkpoint bytes
only, until a convolution that reads int8 weights itself exists.

The contract is calibrate -> gate -> swap:

1. `quantize_variables` walks a state_dict and replaces each selected
   kernel by `{"q8": int8, "scale": float32}`; biases, norm scales and
   batch statistics stay float32.
2. `calibrate_and_quantize` runs the float32 function and the quantized
   one over a representative batch stream and computes the accuracy
   delta: top-1 disagreement for logits-shaped outputs, relative output
   MSE otherwise. A delta above `tolerance` REFUSES to serve: a typed
   `quant_calibrated{model, delta, accepted: false}` and
   `QuantizationRejected`.
3. The accepted `QuantizedModel` registers on an Engine like any other
   model (its variables ARE the int8 tree, its fn dequantizes), and a
   re-calibrated int8 tree of the same shapes hot-swaps through
   `Engine.set_variables` / `clone_with_variables` with no warm-up.

Which leaves, and along which axis. The reference selects flax leaves
named `kernel`, `w`, `w1` or `w2` of two or more float dimensions
(`KERNEL_NAMES`); the port applies the same rule to each key's flax path
(convert.py `flax_path`: a `weight` is a flax `kernel`). The reference's
scale runs along flax's last axis, the output channel. The port stores
converted kernels output-first (convert.py), so:

- a `weight` (conv OIHW, dense (out, in)) is viewed as (G, C, rest)
  with C the flax kernel's last axis: the scale has C entries, along
  axis 1 of that view. G is 1 except for a DenseGeneral with several
  output axes, the attention `qkv` (flax (dim, 3, heads, hd), the port
  (3 * heads * hd, dim)), whose scale has hd entries shared by q, k, v
  and the heads; `features=` (see `dense_features`) names those;
- a leaf that keeps flax's layout (V-MoE's `w1`, `w2`) scales along its
  last axis, as the reference.

Scales ride checkpoints through the crc32c sidecar: `scales_host_state`
/ `apply_scales` round-trip the per-channel scales as JSON host state
beside the int8 arrays (CheckpointManager.save_tree / restore_tree).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from deep_vision_tpu_torch.convert import flax_path
from deep_vision_tpu_torch.serve.engine import ServeError

__all__ = [
    "QuantizationRejected",
    "QuantizedModel",
    "apply_scales",
    "calibrate_and_quantize",
    "dense_features",
    "dequantize_variables",
    "quantize_variables",
    "quantized_fn",
    "scales_host_state",
]

#: leaf names treated as matmul/conv kernels (flax's `kernel`, the
#: toy/test convention `w*`); everything else stays float32
KERNEL_NAMES = ("kernel", "w", "w1", "w2")

#: marker keys of one quantized leaf
_Q_KEYS = frozenset(("q8", "scale"))


class QuantizationRejected(ServeError):
    """The int8 engine's accuracy delta exceeded the gate; serving the
    float32 engine is the only honest fallback."""


def _flax_leaf_path(key: str) -> Tuple[str, ...]:
    return tuple(flax_path(key).split("/"))


def _default_select(path: tuple, leaf) -> bool:
    return (bool(path) and path[-1] in KERNEL_NAMES
            and leaf.dim() >= 2 and leaf.is_floating_point())


def _is_quantized_leaf(node) -> bool:
    return (isinstance(node, Mapping) and set(node) == _Q_KEYS
            and getattr(node["q8"], "dtype", None) == torch.int8)


def _output_first(key: str) -> bool:
    """A converted flax kernel (`weight`): stored output-first."""
    return _flax_leaf_path(key)[-1] == "kernel"


def dense_features(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{state_dict key: flax output features} for every DenseGeneral of
    `model` with more than one output axis (the attention `qkv`):
    what `quantize_variables(features=)` needs to scale those weights as
    the reference does."""
    out = {}
    for name, mod in model.named_modules():
        features = getattr(mod, "features", None)
        if isinstance(features, tuple) and len(features) > 1 and \
                isinstance(getattr(mod, "weight", None), torch.Tensor):
            out[f"{name}.weight" if name else "weight"] = features
    return out


def _channels(key: str, w: torch.Tensor,
              features: Mapping[str, Tuple[int, ...]]) -> int:
    """C, the flax kernel's last axis, for an output-first `weight`."""
    if key in features:
        return int(features[key][-1])
    path = _flax_leaf_path(key)
    if len(path) >= 3 and path[-2] == "qkv" and \
            path[-3].startswith("Attention_"):
        raise ServeError(
            f"quantize_variables: {key!r} is an attention DenseGeneral "
            "whose flax kernel has several output axes; pass "
            "features=dense_features(model) so its scale runs along the "
            "head dimension, as the reference's")
    return int(w.shape[0])


def _grouped(w: torch.Tensor, c: int) -> torch.Tensor:
    """The (G, C, rest) view of an output-first weight."""
    return w.reshape(-1, c, math.prod(w.shape[1:]))


def quantize_variables(variables: Mapping[str, torch.Tensor],
                       select: Optional[Callable] = None,
                       features: Optional[Mapping[str, Tuple[int, ...]]]
                       = None):
    """(qvars, report): the state_dict with each selected kernel replaced
    by `{"q8": int8, "scale": float32 (C,)}`, on the kernel's device.

    `select(path, leaf)` takes the key's flax path as a tuple (default:
    the reference's rule). Per-OUTPUT-channel symmetric scales, as the
    reference's: `scale = max(amax(|w|) / 127, 1e-12)` over every axis
    but the output channel, `q8 = clip(round(w / scale), -127, 127)`.
    """
    select = select or _default_select
    features = dict(features or {})
    report = {"quantized_leaves": 0, "skipped_leaves": 0,
              "bytes_f32": 0, "bytes_int8": 0}
    qvars = {}
    for key, leaf in variables.items():
        if not select(_flax_leaf_path(key), leaf):
            report["skipped_leaves"] += 1
            qvars[key] = leaf
            continue
        w = leaf.detach().float()
        if _output_first(key):
            c = _channels(key, w, features)
            g = _grouped(w, c)
            amax = g.abs().amax(dim=(0, 2))
            scale = torch.clamp_min(amax / 127.0, 1e-12)
            q = (g / scale.reshape(1, c, 1)).reshape(w.shape)
        else:
            amax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
            scale = torch.clamp_min(amax / 127.0, 1e-12)
            q = w / scale
        q8 = torch.clamp(torch.round(q), -127, 127).to(torch.int8)
        report["quantized_leaves"] += 1
        report["bytes_f32"] += w.numel() * 4
        report["bytes_int8"] += q8.numel() + scale.numel() * 4
        qvars[key] = {"q8": q8, "scale": scale}
    if report["quantized_leaves"] == 0:
        raise ServeError(
            "quantize_variables found no kernel leaves (names "
            f"{KERNEL_NAMES}, ndim >= 2); pass select= for exotic trees")
    report["compression"] = round(
        report["bytes_f32"] / max(1, report["bytes_int8"]), 2)
    return qvars, report


def dequantize_variables(qvars: Mapping[str, object]
                         ) -> Dict[str, torch.Tensor]:
    """The float32 state_dict: `q8.float() * scale` per quantized leaf,
    one multiply an element, as the reference's."""
    out = {}
    for key, node in qvars.items():
        if _is_quantized_leaf(node):
            q8, scale = node["q8"], node["scale"]
            if _output_first(key):
                c = scale.numel()
                out[key] = (_grouped(q8.float(), c)
                            * scale.reshape(1, c, 1)).reshape(q8.shape)
            else:
                out[key] = q8.float() * scale
        else:
            out[key] = node
    return out


def quantized_fn(fn: Callable) -> Callable:
    """Wrap a serving predict fn `fn(variables, images)` so it takes the
    int8 tree, dequantized at every call."""
    def qfn(qvariables, images):
        return fn(dequantize_variables(qvariables), images)

    return qfn


class QuantizedModel:
    """An accepted calibrate-and-quantize result, ready to register:
    `engine.register(m.name, m.fn, m.variables, ...)`."""

    __slots__ = ("name", "fn", "variables", "report", "delta", "metric",
                 "tolerance")

    def __init__(self, name, fn, variables, report, delta, metric,
                 tolerance):
        self.name = name
        self.fn = fn
        self.variables = variables
        self.report = report
        self.delta = delta
        self.metric = metric
        self.tolerance = tolerance


def _leaves(out) -> list:
    """An output's arrays in the reference's tree order (dict keys
    sorted, sequences in order)."""
    if isinstance(out, Mapping):
        return [a for k in sorted(out) for a in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for v in out for a in _leaves(v)]
    return [out]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _accuracy_delta(f32_outs: list, q_outs: list) -> tuple:
    """(delta, metric): top-1 disagreement when the output is a single
    logits-shaped array, relative output MSE otherwise (both in [0, ~1],
    0 = identical)."""
    first = f32_outs[0]
    logits_shaped = (not isinstance(first, (Mapping, list, tuple))
                     and getattr(first, "ndim", 0) == 2)
    if logits_shaped:
        mismatch = total = 0
        for a, b in zip(f32_outs, q_outs):
            a, b = _host(a), _host(b)
            mismatch += int(np.sum(np.argmax(a, -1) != np.argmax(b, -1)))
            total += a.shape[0]
        return mismatch / max(1, total), "top1"
    num = den = 0.0
    for a, b in zip(f32_outs, q_outs):
        for la, lb in zip(_leaves(a), _leaves(b)):
            la = _host(la).astype(np.float64)
            lb = _host(lb).astype(np.float64)
            num += float(np.sum((la - lb) ** 2))
            den += float(np.sum(la ** 2))
    return num / max(den, 1e-12), "output_mse"


def calibrate_and_quantize(
    name: str,
    fn: Callable,
    variables: Mapping[str, torch.Tensor],
    calib_batches: Iterable,
    tolerance: float = 0.02,
    journal=None,
    select: Optional[Callable] = None,
    features: Optional[Mapping[str, Tuple[int, ...]]] = None,
) -> QuantizedModel:
    """Quantize `variables` and GATE the result on a representative
    batch stream: the float32 function and the int8 one run the same
    batches (on the variables' device), and the delta must clear
    `tolerance` or the int8 tree is refused. Every verdict is a typed
    `quant_calibrated` event.

    `calib_batches`: input arrays or tensors shaped like serving traffic
    (a handful is enough: weight-only PTQ needs no activation
    statistics, the gate judges output drift)."""
    batches = [torch.as_tensor(np.asarray(b)) if not isinstance(
        b, torch.Tensor) else b for b in calib_batches]
    if not batches:
        raise ServeError(f"calibrate_and_quantize({name!r}) needs at least "
                         "one calibration batch")
    qvars, report = quantize_variables(variables, select=select,
                                       features=features)
    qfn = quantized_fn(fn)
    device = next(iter(variables.values())).device
    with torch.inference_mode():
        f32_outs = [fn(variables, b.to(device)) for b in batches]
        q_outs = [qfn(qvars, b.to(device)) for b in batches]
    delta, metric = _accuracy_delta(f32_outs, q_outs)
    accepted = bool(delta <= tolerance)
    if journal is not None:
        journal.write(
            "quant_calibrated", model=name, delta=float(round(delta, 6)),
            accepted=accepted, metric=metric, tolerance=float(tolerance),
            batches=len(batches),
            quantized_leaves=report["quantized_leaves"],
            compression=report["compression"])
    if not accepted:
        raise QuantizationRejected(
            f"int8 {name!r} failed the accuracy gate: {metric} delta "
            f"{delta:.4g} > tolerance {tolerance:g} over {len(batches)} "
            "calibration batches — serve the f32 engine and investigate "
            "(an outlier channel usually wants a per-layer exclusion)")
    return QuantizedModel(name, qfn, qvars, report, float(delta), metric,
                          float(tolerance))


# -- checkpoint sidecar round-trip -------------------------------------------

def scales_host_state(qvars: Mapping[str, object]) -> dict:
    """Per-channel scales as a JSON-serialisable dict (key -> list of
    floats) for the crc32c checkpoint sidecar: the int8 arrays ride the
    array checkpoint, the scales ride the sidecar, and `apply_scales`
    re-marries them at restore."""
    return {key: [float(s) for s in node["scale"].detach().cpu()
                  .reshape(-1).tolist()]
            for key, node in qvars.items() if _is_quantized_leaf(node)}


def apply_scales(qvars: Mapping[str, object], host_scales: dict):
    """The quantized tree with every scale replaced from sidecar host
    state; a key or length mismatch raises instead of silently serving
    mis-scaled weights."""
    out, seen = {}, set()
    for key, node in qvars.items():
        if not _is_quantized_leaf(node):
            out[key] = node
            continue
        if key not in host_scales:
            raise ServeError(
                f"sidecar carries no scales for quantized leaf {key!r}")
        scale = node["scale"]
        stored = torch.tensor(np.asarray(host_scales[key], np.float32))
        if stored.numel() != scale.numel():
            raise ServeError(
                f"sidecar scales for {key!r} have {stored.numel()} "
                f"channels, tree has {scale.numel()}")
        seen.add(key)
        out[key] = {"q8": node["q8"], "scale": stored.reshape(
            scale.shape).to(scale.device)}
    extra = set(host_scales) - seen
    if extra:
        raise ServeError(
            f"sidecar carries scales for unknown leaves {sorted(extra)}")
    return out
