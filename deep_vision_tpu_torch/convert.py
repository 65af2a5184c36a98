"""Bridge the JAX package's variables into the port's state_dict.

`variables_from_jax(tree)` takes the flax `{"params": ..., "batch_stats":
...}` tree with numpy leaves (`jax.device_get` of the reference's
variables; nothing here imports JAX) and returns a state_dict for the
port's model of the same name. The port's submodules carry the flax
auto-names, so the mapping is by path:

    params/Darknet53_0/DarknetConv_0/ConvBN_0/Conv_0/kernel  (H, W, I, O)
        -> Darknet53_0.DarknetConv_0.ConvBN_0.Conv_0.weight  (O, I, H, W)
    params/SpaceToDepthStem_0/kernel (7, 7, 3, 64)
        -> SpaceToDepthStem_0.weight (64, 3, 7, 7)
    params/Dense_0/kernel  (in, out)  -> Dense_0.weight  (out, in)
    params/.../Attention_0/qkv/kernel (in, 3, H, Dh)
        -> ....Attention_0.qkv.weight (3 * H * Dh, in)
    params/.../Attention_0/qkv/bias (3, H, Dh) -> ....qkv.bias (3 * H * Dh,)
    params/.../Attention_0/out/kernel (H, Dh, out)
        -> ....Attention_0.out.weight (out, H * Dh)
    params/patch_embed/kernel (P, P, 3, dim) -> patch_embed.weight (OIHW)
    params/pos_embed, params/.../LayerNorm_0/{scale,bias}  (as they are)
    params/.../Conv_0/bias                    -> ....Conv_0.bias
    params/.../BatchNorm_0/{scale,bias}       -> ....BatchNorm_0.{scale,bias}
    batch_stats/.../BatchNorm_0/{mean,var}    -> ....BatchNorm_0.{mean,var}
    params/.../MoeMlp_0/{router,w1,b1,w2,b2}  -> ....MoeMlp_0.<same>
        (V-MoE: the router (dim, E) and the stacked expert weights keep
        the reference's layout)

`model.load_state_dict(sd)` (strict) then proves the mapping complete.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")
#: flax DenseGeneral modules by (parent prefix, name): how many leading
#: kernel axes are inputs. Their kernels (*in_shape, *features) become the
#: port's 2-D (prod(features), prod(in_shape)) weights, their biases flat.
DENSE_GENERAL = {("Attention_", "qkv"): 1, ("Attention_", "out"): 2}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def torch_key(path: Tuple[str, ...]) -> str:
    """flax leaf path (collection stripped) -> state_dict key."""
    *mods, leaf = path
    return ".".join(mods + ["weight" if leaf == "kernel" else leaf])


def flax_path(key: str) -> str:
    """state_dict key -> flax leaf path, '/'-joined without the collection
    (the names the reference's optimizer masks match on)."""
    *mods, leaf = key.split(".")
    return "/".join(mods + ["kernel" if leaf == "weight" else leaf])


def _dense_general_inputs(path: Tuple[str, ...]):
    """Input-axis count of the DenseGeneral owning this leaf, else None."""
    if len(path) < 3:
        return None
    for (parent, name), n_in in DENSE_GENERAL.items():
        if path[-2] == name and path[-3].startswith(parent):
            return n_in
    return None


def variables_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (numpy leaves) -> the port's state_dict."""
    unknown = sorted(set(tree) - set(COLLECTIONS))
    if unknown:
        raise ValueError(f"collections {unknown} have no counterpart in the "
                         f"port (known: {COLLECTIONS})")
    out: Dict[str, torch.Tensor] = {}
    for col in COLLECTIONS:
        for path, arr in _leaves(tree.get(col, {})):
            n_in = _dense_general_inputs(path)
            if n_in is not None:
                if path[-1] == "kernel":
                    arr = arr.reshape(int(np.prod(arr.shape[:n_in])), -1).T
                else:
                    arr = arr.reshape(-1)
            elif path[-1] == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = arr.T  # (in, out) -> (out, in)
                else:
                    raise ValueError(f"{'/'.join(path)}: only conv (HWIO), "
                                     f"dense (in, out) and attention "
                                     f"DenseGeneral kernels are bridged, "
                                     f"got {arr.shape}")
            out[torch_key(path)] = torch.tensor(arr)  # a contiguous copy
    return out
