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
gives the same model, and `jax_tree_from_state_dict` goes back: a port
state_dict to the JAX package's tree, for the msgpack files it reads.
mPLUG's tree needs renames beyond that rule (`mplug_state_dict_from_jax`). `stage2_from_jax` carries a JAX stage-2 state
(`crvqa_tpu/train/stage2.py:Stage2State`, as numpy) across the same way,
and `mplug_train_state_from_jax` an mPLUG training state and
`carry_into_stage1_state` a stage-1/3 one, so both packages can start a
trajectory from one state.
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
            if isinstance(value, torch.Tensor):  # a msgpack bf16 leaf
                arr = value.detach().float().numpy()
            else:
                arr = np.asarray(value)
            if arr.dtype.name == "bfloat16":  # torch.from_numpy has no bf16
                arr = arr.astype(np.float32)
            leaf, arr = _leaf(key, arr)
            name = ".".join(([prefix] if prefix else [])
                            + _torch_parts(path) + [leaf])
            out[name] = torch.from_numpy(np.array(arr, copy=True))

    walk(params, ())
    return out


def _jax_leaf(owner: torch.nn.Module, name: str, t: torch.Tensor
              ) -> tuple[str, torch.Tensor]:
    """`_leaf` read in reverse, by the type of the module that owns the
    tensor: a Linear's weight is a Dense kernel [in, out], an Embedding's
    an `embedding`, a LayerNorm's a `scale`."""
    if name == "weight":
        if isinstance(owner, torch.nn.Linear):
            return "kernel", t.T
        if isinstance(owner, torch.nn.Embedding):
            return "embedding", t
        if isinstance(owner, torch.nn.LayerNorm):
            return "scale", t
    if name == "weight_v":
        return "v", t.T
    if name == "weight_g":
        return "g", t.reshape(1)
    return name, t


def _sorted_tree(node: dict) -> dict:
    """Keys sorted at every level, the order of a tree that went through
    `jax.device_get` (the JAX package's files)."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(node.items())}


def jax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                             model: torch.nn.Module) -> dict[str, Any]:
    """The port's state_dict (names of `model`, which may live on the meta
    device) -> the JAX package's nested param tree of CPU tensors, the
    inverse of `state_dict_from_jax`: `a.3.b` -> `a_3` / `b`, and each leaf
    renamed and laid out by its owning module's type (`_jax_leaf`). Keys
    are sorted as in the JAX package's own files."""
    tree: dict[str, Any] = {}
    for name, t in state_dict.items():
        module_path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(module_path)
        parts = module_path.split(".") if module_path else []
        path: list[str] = []
        for p in parts:
            if p.isdigit() and path:
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        key, value = _jax_leaf(owner, leaf, t.detach().cpu())
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[key] = value.contiguous()
    return _sorted_tree(tree)


def stage2_from_jax(frozen_params: Mapping[str, Any],
                    train_params: Mapping[str, Any],
                    scores: Mapping[str, Any], thresholds: Mapping[str, Any],
                    specs, classifier_key: str = "classifier"
                    ) -> dict[str, Any]:
    """A JAX stage-2 state's parts (numpy) -> the port's:

    - `params`: the full state_dict (frozen backbone + the classifier under
      `classifier_key`, "cls" for VisualBERT), the `params` argument of
      `crvqa_tpu_torch.train.stage2.init_state`;
    - `scores`: by spec key, transposed to the torch layout [out, in]
      (embeddings keep [vocab, hidden]);
    - `thresholds`: by spec key, 0-d fp32 tensors;
    - `lmh` (when present): LearnedMixin's `bias_lin.weight` [1, hidden]
      (the flax kernel [hidden, 1] transposed), `bias_lin.bias` and
      `smooth_param`.

    `carry_into_state` writes these into a port state."""
    params = state_dict_from_jax(frozen_params)
    params.update(state_dict_from_jax(train_params["classifier"],
                                      prefix=classifier_key))
    port_scores, port_thresholds = mask_state_from_jax(scores, thresholds,
                                                       specs)
    out = {"params": params, "scores": port_scores,
           "thresholds": port_thresholds}
    if "lmh" in train_params:
        out["lmh"] = lmh_from_jax(train_params["lmh"])
    return out


def lmh_from_jax(lmh: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """LearnedMixin's JAX parameters -> the port's: `bias_lin.weight`
    [1, hidden] (the flax kernel [hidden, 1] transposed), `bias_lin.bias`,
    `smooth_param`."""
    return {
        "bias_lin.weight": torch.from_numpy(np.array(
            np.asarray(lmh["bias_lin"]["kernel"], np.float32).T)),
        "bias_lin.bias": torch.from_numpy(
            np.asarray(lmh["bias_lin"]["bias"], np.float32).copy()),
        "smooth_param": torch.from_numpy(
            np.asarray(lmh["smooth_param"], np.float32).copy())}


@torch.no_grad()
def carry_into_stage1_state(state, params: Mapping[str, Any],
                            lmh: Mapping[str, Any] | None) -> None:
    """Overwrite a port `Stage1State`'s parameters and LMH parameters in
    place with a JAX stage-1 state's (`params`, `lmh_params`, as numpy)."""
    for name, t in state_dict_from_jax(params).items():
        state.params[name].copy_(t)
    if lmh is not None:
        for name, t in lmh_from_jax(lmh).items():
            state.lmh_params[name].copy_(t)


@torch.no_grad()
def carry_into_state(state, carried: Mapping[str, Any]) -> None:
    """Overwrite a port `Stage2State`'s scores, thresholds and LMH
    parameters in place with `stage2_from_jax`'s (the frozen backbone and
    classifier enter through `init_state`'s `params`)."""
    for key, t in carried["scores"].items():
        state.scores[key].copy_(t)
    state.thresholds = {k: t.to(state.scores[k].device)
                        for k, t in carried["thresholds"].items()}
    for name, t in carried.get("lmh", {}).items():
        state.train_params["lmh"][name].copy_(t)


# ------------------------------------------------------------------ mPLUG

_VIT_MODULES = {"attn_out_proj": ["attn", "out_proj"],
                "mlp_c_fc": ["mlp", "c_fc"], "mlp_c_proj": ["mlp", "c_proj"]}
_DECODER_HEAD = {
    "predictions_transform_dense": ["cls", "predictions", "transform",
                                    "dense"],
    "predictions_transform_LayerNorm": ["cls", "predictions", "transform",
                                        "LayerNorm"]}


def mplug_torch_name(path: tuple[str, ...], arr: np.ndarray
                     ) -> tuple[str, np.ndarray]:
    """One leaf of the JAX package's mPLUG param tree (its path, its array)
    -> the port's state_dict name and tensor layout (the reference's names;
    `crvqa_tpu/core/torch_compat.py:_mplug_remap_key` read in reverse):

    - ViT: `resblocks_{l}` -> `transformer.resblocks.{l}`, `ln_1` keeps its
      name, the fused `attn_in_proj` Dense -> `attn.in_proj_weight` /
      `attn.in_proj_bias`, `attn_out_proj` -> `attn.out_proj`,
      `mlp_c_fc` -> `mlp.c_fc`; the conv kernel HWIO -> OIHW;
    - text / fusion encoders: `layer_{l}` -> `encoder.layer.{l}`;
    - decoder: `embeddings` and `layer_{l}` under `bert`, the LM head's
      transform under `cls.predictions.transform`, `predictions_bias` ->
      `cls.predictions.bias`;
    - Dense kernels [in, out] -> weights [out, in]; LayerNorm `scale` and
      Embed `embedding` -> `weight`."""
    tower, mods, leaf = path[0], list(path[1:-1]), path[-1]
    if tower == "visual_encoder":
        parts = ["visual_encoder", "visual"]
        if mods and mods[0].startswith("resblocks_"):
            parts += ["transformer", "resblocks", mods[0].split("_")[1]]
            mods = mods[1:]
            if mods == ["attn_in_proj"]:
                return (".".join(parts + ["attn", "in_proj_" + (
                    "weight" if leaf == "kernel" else "bias")]),
                    arr.T if leaf == "kernel" else arr)
            if mods and mods[0] in _VIT_MODULES:
                mods = _VIT_MODULES[mods[0]] + mods[1:]
        if mods == ["conv1"]:
            return ".".join(parts + ["conv1", "weight"]), arr.transpose(
                3, 2, 0, 1)
        parts += mods
    elif tower in ("text_encoder", "fusion_encoder", "text_decoder"):
        body = ["bert"] if tower == "text_decoder" else []
        parts = [tower]
        if mods and mods[0].startswith("layer_"):
            parts += body + ["encoder", "layer", mods[0].split("_")[1]]
            mods = mods[1:]
        elif mods and mods[0] == "embeddings":
            parts += body
        elif mods and mods[0] in _DECODER_HEAD:
            parts += _DECODER_HEAD[mods[0]]
            mods = mods[1:]
        elif not mods and leaf == "predictions_bias":
            return f"{tower}.cls.predictions.bias", arr
        parts += mods
    else:  # the ViT-L adapter: visn_fc, visn_layer_norm
        parts = [tower] + mods
    name, arr = _leaf(leaf, arr)
    return ".".join(parts + [name]), arr


def mplug_state_dict_from_jax(params: Mapping[str, Any]
                              ) -> dict[str, torch.Tensor]:
    """The JAX package's mPLUG params (nested dict of arrays) -> the port's
    state_dict; `load_state_dict(..., strict=True)` then gives the same
    model."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            arr = np.asarray(value)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            name, arr = mplug_torch_name(path + (key,), arr)
            out[name] = torch.from_numpy(np.array(arr, copy=True))

    walk(params, ())
    return out


def mask_state_from_jax(scores: Mapping[str, Any],
                        thresholds: Mapping[str, Any], specs
                        ) -> tuple[dict[str, torch.Tensor],
                                   dict[str, torch.Tensor]]:
    """A JAX masker's (scores, thresholds), keyed by spec key, -> the
    port's: scores in the torch layout [out, in] (embeddings keep theirs),
    thresholds as fp32 tensors."""
    by_key = {s.key: s for s in specs}
    port_scores = {}
    for key, arr in scores.items():
        arr = np.asarray(arr, np.float32)
        if key in by_key and not by_key[key].is_embedding:
            arr = arr.T  # a bias mask's scores are a vector with no spec
        port_scores[key] = torch.from_numpy(np.array(arr, copy=True))
    return port_scores, {k: torch.tensor(np.asarray(v, np.float32))
                         for k, v in thresholds.items()}


def _mplug_leaves(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`mplug_state_dict_from_jax` over a tree whose keys may be '/'-joined
    paths and whose absent leaves are None (an optimizer group's view)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for key, value in node.items():
            here = path + tuple(key.split("/"))
            if isinstance(value, Mapping):
                walk(value, here)
            elif value is not None:
                name, arr = mplug_torch_name(here, np.asarray(value,
                                                              np.float32))
                out[name] = torch.from_numpy(np.array(arr, copy=True))

    walk(tree, ())
    return out


def mplug_moments_from_jax(groups: Mapping[str, Any], mode: str, specs
                           ) -> dict[str, torch.Tensor]:
    """One Adam moment of the JAX two-group optimizer -> the port's flat
    dict keyed like `mplug_train.trainable`. `groups` maps each group
    ('body', 'visual') to that group's moment tree over the trainable tree
    (mask mode: {"scores": {key: array}, "head": {'/'-path: array}}; full
    mode: the param tree), with None where a leaf belongs to the other
    group."""
    by_key = {s.key: s for s in specs or ()}
    out: dict[str, torch.Tensor] = {}
    for tree in groups.values():
        if mode == "mask":
            for key, arr in tree["scores"].items():
                if arr is None:
                    continue
                arr = np.asarray(arr, np.float32)
                if key in by_key and not by_key[key].is_embedding:
                    arr = arr.T  # bias-mask scores are vectors: no spec
                out[f"scores/{key}"] = torch.from_numpy(
                    np.array(arr, copy=True))
            out.update({f"head/{k}": v
                        for k, v in _mplug_leaves(tree["head"]).items()})
        else:
            out.update({f"params/{k}": v
                        for k, v in _mplug_leaves(tree).items()})
    return out


@torch.no_grad()
def mplug_train_state_from_jax(state, jax_state: Mapping[str, Any], mode: str,
                               specs=None) -> None:
    """Overwrite a port `MPlugState` (built by `mplug_train.init_state(...,
    train=True)` with the same configuration) in place with a JAX
    `MPlugState` handed over as numpy: `jax_state` holds "step", "params"
    and, where the state has them, "scores", "thresholds", "params_m",
    "scores_m", "thresholds_m", and "mu" / "nu": each Adam moment per group,
    as `mplug_moments_from_jax` takes them. Dtypes and devices stay the
    port state's."""
    def copy(dst: dict, src: dict, what: str) -> None:
        if set(dst) != set(src):
            raise KeyError(f"{what}: keys differ "
                           f"({sorted(set(dst) ^ set(src))[:5]})")
        for k, t in src.items():
            dst[k].copy_(t.reshape(dst[k].shape))

    copy(state.params, mplug_state_dict_from_jax(jax_state["params"]),
         "params")
    for suffix in ("", "_m"):
        if jax_state.get("scores" + suffix) is None:
            continue
        scores, thresholds = mask_state_from_jax(
            jax_state["scores" + suffix], jax_state["thresholds" + suffix],
            specs)
        dst = getattr(state, "scores" + suffix)
        copy(dst, scores, "scores" + suffix)
        dev = next(iter(dst.values())).device
        setattr(state, "thresholds" + suffix,
                {k: t.to(dev) for k, t in thresholds.items()})
    if jax_state.get("params_m") is not None:
        copy(state.params_m, mplug_state_dict_from_jax(jax_state["params_m"]),
             "params_m")
    if jax_state.get("mu") is not None:
        copy(state.opt_state.mu,
             mplug_moments_from_jax(jax_state["mu"], mode, specs), "mu")
        copy(state.opt_state.nu,
             mplug_moments_from_jax(jax_state["nu"], mode, specs), "nu")
    state.step = state.opt_state.count = int(jax_state["step"])
