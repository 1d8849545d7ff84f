"""JAX-package parameters -> the port's state_dict.

The JAX package keeps parameters as a nested dict (flax param tree) whose
paths were chosen to map 1:1 onto the reference PyTorch names; its own
`core/torch_compat.py:flax_to_torch_state_dict` spells the mapping. This is
the same mapping, written without flax, over a nested dict of numpy arrays
(`jax.tree.map(np.asarray, params)`):

- a path element `name_N` with a numeric suffix becomes `name.N`
  (`layer_3` -> `layer.3`, `main_0` -> `main.0`);
- Dense `kernel` [in, out] -> `weight` [out, in] (transposed);
- Embed `embedding` and LayerNorm `scale` -> `weight`;
- WeightNormDense `v` [in, out] -> `weight_v` [out, in], `g` [1] ->
  `weight_g` [].

`model.load_state_dict(state_dict_from_jax(params), strict=True)` then
gives the same model.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _torch_parts(path: tuple[str, ...]) -> list[str]:
    parts: list[str] = []
    for p in path:
        stem, _, idx = p.rpartition("_")
        if stem and idx.isdigit():
            parts.extend([stem, idx])
        else:
            parts.append(p)
    return parts


def _leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        return "weight", arr.T
    if name in ("embedding", "scale"):
        return "weight", arr
    if name == "v":
        return "weight_v", arr.T
    if name == "g":
        return "weight_g", arr.reshape(())
    return name, arr


def state_dict_from_jax(params: Mapping[str, Any], prefix: str = ""
                        ) -> dict[str, torch.Tensor]:
    """Nested {name: {... : array}} -> {"a.b.0.weight": tensor}."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            leaf, arr = _leaf(key, np.asarray(value))
            name = ".".join(([prefix] if prefix else [])
                            + _torch_parts(path) + [leaf])
            out[name] = torch.from_numpy(np.array(arr, copy=True))

    walk(params, ())
    return out
