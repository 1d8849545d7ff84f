"""JAX-package parameters -> the port's state_dict.

The JAX package keeps parameters as a nested dict (flax param tree) whose
paths were chosen to map 1:1 onto the reference PyTorch names; its own
`core/torch_compat.py:flax_to_torch_state_dict` spells the mapping. This is
the same mapping, written without flax, over a nested dict of numpy arrays
(`jax.tree.map(np.asarray, params)`):

- a path element `name_N` with a numeric suffix becomes `name.N`
  (`layer_3` -> `layer.3`, `main_0` -> `main.0`);
- Dense `kernel` [in, out] -> `weight` [out, in] (transposed; a stacked
  kernel of the scan layout [L, in, out] -> [L, out, in]);
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
from typing import Any, Optional

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


def _swap(arr):
    """The last two axes swapped: a kernel [in, out] <-> a weight [out,
    in], layer by layer for a stacked one (numpy or torch)."""
    return arr.swapaxes(-1, -2)


def _leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        return "weight", _swap(arr)
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
            return "kernel", _swap(t)
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
    return {k: v.float() for k, v in _leaves_from_jax(lmh).items()}


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
        if state.scores[key].shape != t.shape:
            # copy_ would broadcast a () or (H,) gate of another masker
            raise ValueError(f"scores {key}: carried shape "
                             f"{tuple(t.shape)}, the state's "
                             f"{tuple(state.scores[key].shape)}")
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


def _mplug_name_layout(path: tuple[str, ...]
                       ) -> tuple[str, Optional[tuple[int, ...]]]:
    """`mplug_torch_name`'s rule without the array: the port's name and
    the axis permutation that takes the JAX leaf to the port's layout
    (None: the same layout)."""
    tower, mods, leaf = path[0], list(path[1:-1]), path[-1]
    if tower == "visual_encoder":
        parts = ["visual_encoder", "visual"]
        if mods and mods[0].startswith("resblocks_"):
            parts += ["transformer", "resblocks", mods[0].split("_")[1]]
            mods = mods[1:]
            if mods == ["attn_in_proj"]:
                return (".".join(parts + ["attn", "in_proj_" + (
                    "weight" if leaf == "kernel" else "bias")]),
                    (1, 0) if leaf == "kernel" else None)
            if mods and mods[0] in _VIT_MODULES:
                mods = _VIT_MODULES[mods[0]] + mods[1:]
        if mods == ["conv1"]:
            return ".".join(parts + ["conv1", "weight"]), (3, 2, 0, 1)
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
            return f"{tower}.cls.predictions.bias", None
        parts += mods
    else:  # the ViT-L adapter: visn_fc, visn_layer_norm
        parts = [tower] + mods
    name = {"kernel": "weight", "embedding": "weight", "scale": "weight",
            "v": "weight_v", "g": "weight_g"}.get(leaf, leaf)
    perm = (1, 0) if leaf in ("kernel", "v") else None
    return ".".join(parts + [name]), perm


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
    name, perm = _mplug_name_layout(path)
    if path[-1] == "g":
        return name, arr.reshape(())
    return name, (arr if perm is None else arr.transpose(perm))


def mplug_jax_path(name: str, model: torch.nn.Module) -> tuple[str, ...]:
    """The port's mPLUG parameter name -> its path in the JAX package's
    tree, `mplug_torch_name` read backwards (the leaf named by the owning
    module's type, as `jax_tree_from_state_dict` names it). Checked by
    running the forward rule on the result."""
    parts = name.split(".")
    tower, leaf = parts[0], parts[-1]
    owner = model.get_submodule(".".join(parts[:-1]))
    rest = parts[1:-1]
    if tower == "visual_encoder":
        rest = rest[1:]  # "visual"
        mods = []
        if rest[:2] == ["transformer", "resblocks"]:
            mods, rest = [f"resblocks_{rest[2]}"], rest[3:]
            if rest == ["attn"] and leaf.startswith("in_proj_"):
                path = tuple([tower] + mods + ["attn_in_proj", "kernel"
                             if leaf == "in_proj_weight" else "bias"])
                return _checked(path, name)
            for short, long in _VIT_MODULES.items():
                if rest[:2] == long:
                    mods, rest = mods + [short], rest[2:]
                    break
        if rest == ["conv1"] and leaf == "weight":
            return _checked((tower, "conv1", "kernel"), name)
        mods += rest
    elif tower in ("text_encoder", "fusion_encoder", "text_decoder"):
        if tower == "text_decoder" and rest[:1] == ["bert"]:
            rest = rest[1:]
        elif rest[:3] == ["cls", "predictions", "transform"]:
            rest = [f"predictions_transform_{rest[3]}"] + rest[4:]
        elif rest == ["cls", "predictions"] and leaf == "bias":
            return _checked((tower, "predictions_bias"), name)
        if rest[:2] == ["encoder", "layer"]:
            rest = [f"layer_{rest[2]}"] + rest[3:]
        mods = rest
    else:
        mods = rest
    key, _ = _jax_leaf(owner, leaf, torch.empty(0, 0))
    return _checked(tuple([tower] + mods + [key]), name)


def _checked(path: tuple[str, ...], name: str) -> tuple[str, ...]:
    back, _ = _mplug_name_layout(path)
    if back != name:
        raise KeyError(f"{name}: no JAX path maps back to it ({path} -> "
                       f"{back})")
    return path


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
    port_scores = {k: v.float() for k, v in _by_spec(scores, specs).items()}
    return port_scores, {k: _t(v).float() for k, v in thresholds.items()}


def mplug_moments_from_jax(groups: Mapping[str, Any], mode: str, specs
                           ) -> dict[str, torch.Tensor]:
    """One Adam moment of the JAX two-group optimizer -> the port's flat
    dict keyed like `mplug_train.trainable`. `groups` maps each group
    ('body', 'visual') to that group's moment tree over the trainable tree
    (mask mode: {"scores": {key: array}, "head": {'/'-path: array}}; full
    mode: the param tree), with None (or an empty dict) where a leaf
    belongs to the other group."""
    return _mplug_trainable_from_jax(list(groups.values()), mode, specs)


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


# ------------------------------------------------- whole training states
#
# A JAX training state as `core/checkpoint.load_jax_training_state` reads
# it (flax's state dict: NamedTuples as dicts of their fields, tuples as
# dicts keyed "0", "1", ...; bf16 leaves as torch.bfloat16 tensors) is
# copied into a port state built by the same run configuration, IN PLACE,
# leaf by leaf in the port's layout: Dense kernels [in, out] -> weights
# [out, in], scores and masks by spec key -> the port's keys and layout,
# the optimizer's moments beside the leaves they belong to, the PRNG key
# -> `TrainRNG.from_jax_key`. Shapes must agree; each leaf keeps the
# dtype the port state gives it (the copy casts a JAX fp32 backbone to the
# dtype the model computes in, as the port's `init_state` does), except
# that optimizer moments must already have the port's (--moment_dtype).
# `jax_from_*_state` go back, to the tree the JAX package's
# `load_checkpoint` reads into its state template.

SCAN_LAYERS = ("layers_l", "layers_r", "layers_x")


def _t(x) -> torch.Tensor:
    """A msgpack leaf as a tensor of its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.from_numpy(np.array(x, copy=True))


def _out(t: torch.Tensor):
    """A port tensor as a leaf of the JAX file: numpy, bf16 as a tensor
    (the codec writes both)."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _reject_scan(tree: Mapping[str, Any], path: str) -> None:
    """A stage-1/3 state in the scan layout raises: only the stage-2 CLIs
    take --scan_layers, so no JAX CLI writes one."""
    def walk(node, where):
        for k, v in node.items():
            if k in SCAN_LAYERS:
                raise ValueError(
                    f"{path}: stacked layers at {where}/{k}, the scan "
                    "layout of a stage-1/3 state; no CLI of the JAX package "
                    "writes one (only stage 2 takes --scan_layers)")
            if isinstance(v, Mapping):
                walk(v, f"{where}/{k}")
    walk(tree, "")


def _leaves_from_jax(tree: Mapping[str, Any], prefix: str = ""
                     ) -> dict[str, torch.Tensor]:
    """`state_dict_from_jax` with each leaf's dtype kept (bool masks,
    bf16 moments)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            leaf, t = _leaf(key, _t(value))
            out[".".join(([prefix] if prefix else []) + _torch_parts(path)
                         + [leaf])] = t.contiguous()

    walk(tree, ())
    return out


def _tree_to_jax(leaves: Mapping[str, torch.Tensor], model: torch.nn.Module,
                 prefix: str = "") -> dict[str, Any]:
    """`jax_tree_from_state_dict` for leaves named under `prefix` in
    `model`, as file leaves."""
    full = {(f"{prefix}.{k}" if prefix else k): v for k, v in leaves.items()}
    tree = jax_tree_from_state_dict(full, model)
    if prefix:
        for p in prefix.split("."):
            tree = tree[p]

    def conv(node):
        return {k: conv(v) if isinstance(v, dict) else _out(v)
                for k, v in node.items()}
    return conv(tree)


def _by_spec(tree: Mapping[str, Any], specs, rename=None
             ) -> dict[str, torch.Tensor]:
    """Leaves keyed by spec key ([in, out] kernels, [L, in, out] stacked)
    -> the port's layout ([out, in], [L, out, in]; embeddings and the () /
    (H,) gates as they are), keyed by `rename(spec)` (default: the spec
    key). The map is its own inverse."""
    by_key = {s.key: s for s in specs or ()}
    out = {}
    for key, value in tree.items():
        t = value if isinstance(value, torch.Tensor) else _t(value)
        spec = by_key.get(key)
        if spec is not None and t.dim() >= 2 and not spec.is_embedding:
            t = _swap(t)
        out[rename(spec) if rename and spec else key] = t.contiguous()
    return out


def _copy_leaves(dst: dict, src: Mapping[str, torch.Tensor], what: str,
                 same_dtype: bool = False) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{what}: the file's leaves differ from the run's "
                       f"({sorted(set(dst) ^ set(src))[:5]})")
    for k, t in src.items():
        if tuple(dst[k].shape) != tuple(t.shape):
            raise ValueError(f"{what}/{k}: shape {tuple(t.shape)} in the "
                             f"file, {tuple(dst[k].shape)} in the run")
        if same_dtype and dst[k].dtype != t.dtype:
            raise ValueError(f"{what}/{k}: {t.dtype} in the file, "
                             f"{dst[k].dtype} in the run (another "
                             "--moment_dtype?)")
        dst[k].copy_(t)


def _empty(node, what: str) -> None:
    if not (isinstance(node, Mapping) and not node):
        raise KeyError(f"{what}: expected the clip's empty state, found "
                       f"{type(node).__name__}")


def _kind_error(tree: Mapping[str, Any], want: str) -> ValueError:
    if "frozen_params" in tree:
        have = "stage-2 (mask training) state"
    elif "masks" in tree:
        have = "stage-1/3 state"
    elif "params_m" in tree:
        have = "mPLUG training state"
    else:
        have = f"state with fields {sorted(tree)}"
    return ValueError(f"a JAX {have}, not a {want}: resume it with the CLI "
                      "that wrote it")


def _rng_into(state, key) -> None:
    from ..train.common import TrainRNG

    state.rng = TrainRNG.from_jax_key(np.asarray(key),
                                      state.rng.device.device)


@torch.no_grad()
def stage2_state_from_jax(state, tree: Mapping[str, Any], specs, config
                          ) -> None:
    """A JAX `Stage2State` (crvqa_tpu/train/stage2.py:28-35) into a port
    `Stage2State` built by `stage2.init_state` with the same configuration
    `config` (its `Stage2Config`) and masker `specs`: the frozen backbone
    (from the file: a resume replaces the --seed / --stage1_ckpt
    backbone, as the JAX CLI's load_checkpoint does), the classifier and
    LearnedMixin, the scores (and structured gates) and thresholds, the
    `HfAdamWState` inside the clip chain (its moments and |grad| sums over
    scores, classifier and, when stepped, LMH), the key and the step."""
    if "frozen_params" not in tree:
        raise _kind_error(tree, "stage-2 state")
    _copy_leaves(state.frozen, _leaves_from_jax(tree["frozen_params"]),
                 "frozen_params")
    train = tree["train_params"]
    _copy_leaves(state.train_params["classifier"],
                 _leaves_from_jax(train["classifier"]),
                 "train_params/classifier")
    if ("lmh" in train) != ("lmh" in state.train_params):
        raise KeyError("train_params/lmh: the file's --Masker_type differs "
                       "from the run's")
    if "lmh" in train:
        _copy_leaves(state.train_params["lmh"],
                     _leaves_from_jax(train["lmh"]), "train_params/lmh")
    _copy_leaves(state.scores, _by_spec(tree["scores"], specs), "scores")
    state.thresholds = {k: _t(v).float().to(state.scores[k].device)
                        for k, v in tree["thresholds"].items()}
    _empty(tree["opt_state"]["0"], "opt_state/0")
    opt = tree["opt_state"]["1"]
    with_lmh = config.train_lmh and "lmh" in state.train_params

    def moments(m, what):
        out = {f"scores/{k}": v for k, v in _by_spec(m["scores"],
                                                     specs).items()}
        out.update({f"train/classifier/{k}": v for k, v in
                    _leaves_from_jax(m["train"]["classifier"]).items()})
        lmh = _leaves_from_jax(m["train"].get("lmh") or {})
        if with_lmh:
            out.update({f"train/lmh/{k}": v for k, v in lmh.items()})
        elif any(bool(v.float().abs().sum()) for v in lmh.values()):
            raise ValueError(f"{what}: LearnedMixin moments are not zero "
                             "(the file stepped LMH; the run does not)")
        return out

    _copy_leaves(state.opt_state.mu, moments(opt["mu"], "mu"),
                 "opt_state/mu", same_dtype=True)
    _copy_leaves(state.opt_state.nu, moments(opt["nu"], "nu"),
                 "opt_state/nu", same_dtype=True)
    if (opt["abs_grad_sum"] is None) != (state.opt_state.abs_grad_sum
                                         is None):
        raise KeyError("opt_state/abs_grad_sum: the file's "
                       "--accumulate_grads differs from the run's")
    if opt["abs_grad_sum"] is not None:
        _copy_leaves(state.opt_state.abs_grad_sum,
                     moments(opt["abs_grad_sum"], "abs_grad_sum"),
                     "opt_state/abs_grad_sum")
    state.opt_state.count = int(opt["count"])
    _rng_into(state, tree["rng"])
    state.step = int(tree["step"])


def jax_from_stage2_state(state, model: torch.nn.Module, specs, config
                          ) -> dict[str, Any]:
    """A port `Stage2State` -> the JAX package's `Stage2State` tree
    (`stage2_state_from_jax` read backwards; `model` names the leaves, on
    the meta device or not). The frozen backbone is written in the JAX
    state's dtype, fp32, or bf16 under `backbone_dtype` bfloat16: a weight
    the port holds in the model's bf16 is written as that bf16 value."""
    ck = config.classifier_key
    bf16 = config.backbone_dtype == "bfloat16"
    frozen = {k: (v.to(torch.bfloat16 if bf16 else torch.float32)
                  if v.dtype.is_floating_point else v)
              for k, v in state.frozen.items()}
    train = {"classifier": _tree_to_jax(state.train_params["classifier"],
                                        model, ck)}
    lmh = state.train_params.get("lmh")
    if lmh is not None:
        train["lmh"] = _lmh_to_jax(lmh)

    def moments(flat):
        m = {"scores": {k: _out(v) for k, v in _by_spec(
            {k[len("scores/"):]: v for k, v in flat.items()
             if k.startswith("scores/")}, specs).items()},
             "train": {"classifier": _tree_to_jax(
                 {k[len("train/classifier/"):]: v for k, v in flat.items()
                  if k.startswith("train/classifier/")}, model, ck)}}
        if lmh is not None:
            got = {k[len("train/lmh/"):]: v for k, v in flat.items()
                   if k.startswith("train/lmh/")}
            ref = next(iter(flat.values()))
            m["train"]["lmh"] = _lmh_to_jax(
                got or {k: torch.zeros_like(v, dtype=ref.dtype)
                        for k, v in lmh.items()})
        return m

    opt = state.opt_state
    return {
        "step": np.asarray(state.step, np.int32),
        "frozen_params": _tree_to_jax(frozen, model),
        "train_params": train,
        "scores": {k: _out(v) for k, v in _by_spec(state.scores,
                                                   specs).items()},
        "thresholds": {k: _out(v.float()) for k, v in
                       state.thresholds.items()},
        "opt_state": {"0": {}, "1": {
            "count": np.asarray(opt.count, np.int32), "mu": moments(opt.mu),
            "nu": moments(opt.nu),
            "abs_grad_sum": (None if opt.abs_grad_sum is None
                             else moments(opt.abs_grad_sum))}},
        "rng": state.rng.to_jax_key(),
    }


def _lmh_to_jax(lmh: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    return {"bias_lin": {"bias": _out(lmh["bias_lin.bias"]),
                         "kernel": _out(lmh["bias_lin.weight"].T)},
            "smooth_param": _out(lmh["smooth_param"])}


def _adam_state(opt: Mapping[str, Any], narrow: bool, what: str
                ) -> Mapping[str, Any]:
    """The Adam state inside `make_adam`'s chain: optax.adam's
    (ScaleByAdamState, ScaleByScheduleState) in fp32, `torch_adam`'s
    TorchAdamState with bf16 moments."""
    _empty(opt["0"], f"{what}/0")
    inner = opt["1"]
    if narrow != ("mu" in inner):
        raise ValueError(f"{what}: the file's moments are "
                         f"{'bf16' if 'mu' in inner else 'fp32'}, the "
                         "run's are not (another --moment_dtype?)")
    return inner if narrow else inner["0"]


@torch.no_grad()
def stage1_state_from_jax(state, tree: Mapping[str, Any], config,
                          specs=()) -> None:
    """A JAX `Stage1State` (crvqa_tpu/train/stage1.py:27-33; stages 1 and
    3) into a port `Stage1State` built by `stage1.init_state` with the
    same configuration: every parameter, the LMH parameters, stage 3's
    constant masks (bool by spec key [in, out] -> 0/1 by weight name in
    the weight's dtype; `specs` are the masker's), the `make_adam` state
    (common.py:157-226), the key and the step."""
    from ..masking.masker import weight_name

    if "masks" not in tree:
        raise _kind_error(tree, "stage-1/3 state")
    _reject_scan(tree["params"], "params")
    _copy_leaves(state.params, _leaves_from_jax(tree["params"]), "params")
    if (tree["lmh_params"] is None) != (state.lmh_params is None):
        raise KeyError("lmh_params: the file's --FT_type differs from the "
                       "run's")
    if state.lmh_params is not None:
        _copy_leaves(state.lmh_params, _leaves_from_jax(tree["lmh_params"]),
                     "lmh_params")
    if (tree["masks"] is None) != (state.masks is None):
        raise KeyError("masks: a stage-1 state resumed by stage 3 or back")
    if state.masks is not None:
        _copy_leaves(state.masks, _by_spec(tree["masks"], specs,
                                           rename=weight_name), "masks")
    adam = _adam_state(tree["opt_state"], config.moment_dtype == "bfloat16",
                       "opt_state")
    with_lmh = config.train_lmh and state.lmh_params is not None

    def moments(m):
        out = {f"params/{k}": v for k, v in
               _leaves_from_jax(m["params"]).items()}
        if with_lmh:
            out.update({f"lmh/{k}": v for k, v in
                        _leaves_from_jax(m["lmh"]).items()})
        return out

    _copy_leaves(state.opt_state.mu, moments(adam["mu"]), "opt_state/mu",
                 same_dtype=True)
    _copy_leaves(state.opt_state.nu, moments(adam["nu"]), "opt_state/nu",
                 same_dtype=True)
    state.opt_state.count = int(adam["count"])
    _rng_into(state, tree["rng"])
    state.step = int(tree["step"])


def jax_from_stage1_state(state, model: torch.nn.Module, config, specs=()
                          ) -> dict[str, Any]:
    """A port `Stage1State` -> the JAX package's `Stage1State` tree."""
    from ..masking.masker import weight_name

    lmh = state.lmh_params

    def moments(flat):
        ref = next(iter(flat.values()))
        m = {"params": _tree_to_jax({k[len("params/"):]: v for k, v in
                                     flat.items()
                                     if k.startswith("params/")}, model),
             "lmh": None}
        if lmh is not None:
            got = {k[len("lmh/"):]: v for k, v in flat.items()
                   if k.startswith("lmh/")}
            m["lmh"] = _lmh_to_jax(got or {
                k: torch.zeros_like(v, dtype=ref.dtype)
                for k, v in lmh.items()})
        return m

    opt = state.opt_state
    count = np.asarray(opt.count, np.int32)
    adam = {"count": count, "mu": moments(opt.mu), "nu": moments(opt.nu)}
    inner = (adam if config.moment_dtype == "bfloat16"
             else {"0": adam, "1": {"count": count}})
    masks = None
    if state.masks is not None:
        by_name = {weight_name(s): s.key for s in specs}
        masks = {by_name[k]: v for k, v in state.masks.items()}
        masks = {k: _out(v.bool()) for k, v in
                 _by_spec(masks, specs).items()}
    return {"step": np.asarray(state.step, np.int32),
            "params": _tree_to_jax(state.params, model),
            "lmh_params": None if lmh is None else _lmh_to_jax(lmh),
            "masks": masks,
            "opt_state": {"0": {}, "1": inner},
            "rng": state.rng.to_jax_key()}


# --------------------------------------------------- mPLUG and its --opt

class _Slot(str):
    """A place in an optimizer layout that holds one of the port's slots
    (a tree over the trainables)."""


_COUNT = "<count>"
_ADAM = {"count": _COUNT, "mu": _Slot("mu"), "nu": _Slot("nu")}
_NO_DECAY = {"inner_state": {}}  # add_decayed_weights under its mask
_COUPLED = {"0": _NO_DECAY}      # chain(add_decayed_weights, ...)

# Each --opt's state inside one optax.multi_transform group, as optax and
# the JAX package's timm_optim lay it out (crvqa_tpu/train/
# mplug_train.py:287-348): dicts as they are, `{}` an empty state,
# `_COUNT` the step count, `_Slot(name)` where the port's
# `OptState.slots[name]` (`GroupAdamW`'s `mu` / `nu`) sits. Every group
# holds the same count.
MPLUG_OPT_LAYOUTS: dict[str, Any] = {
    "adamw": {"0": _ADAM, "1": _NO_DECAY, "2": {"count": _COUNT}},
    "adam": dict(_COUPLED, **{"1": {"0": _ADAM, "1": {"count": _COUNT}}}),
    "sgd": dict(_COUPLED, **{"1": {"0": {"trace": _Slot("trace")},
                                   "1": {"count": _COUNT}}}),
    "adadelta": dict(_COUPLED, **{"1": {
        "0": {}, "1": {"e_g": _Slot("e_g"), "e_x": _Slot("e_x")},
        "2": {"count": _COUNT}}}),
    "adafactor": dict(_COUPLED, **{"1": {
        "0": {"count": _COUNT, "v_row": _Slot("v_row"),
              "v_col": _Slot("v_col"), "v": _Slot("v")},
        "1": {}, "2": {"count": _COUNT}, "3": {}, "4": {}}}),
    "rmsprop": dict(_COUPLED, **{"1": {
        "0": {"nu": _Slot("nu")}, "1": {"count": _COUNT},
        "2": {"trace": _Slot("trace")}}}),
    "novograd": dict(_COUPLED, **{"1": {"0": _ADAM,
                                        "1": {"count": _COUNT}}}),
    "lamb": {"0": _ADAM, "1": _NO_DECAY, "2": {}, "3": {"count": _COUNT}},
    "adamp": {"count": _COUNT, "exp_avg": _Slot("mu"),
              "exp_avg_sq": _Slot("nu")},
    "sgdp": {"count": _COUNT, "momentum": _Slot("trace")},
    "rmsproptf": {"count": _COUNT, "square_avg": _Slot("square_avg"),
                  "momentum_buffer": _Slot("momentum_buffer"),
                  "grad_avg": None},
    # not under multi_transform: adahessian_two_group is one transformation
    "adahessian": {"count": _COUNT, "exp_avg": _Slot("exp_avg"),
                   "exp_hess_sq": _Slot("exp_hess_sq")},
}
for _alias, _same in (("fusedadamw", "adamw"), ("fusedadam", "adam"),
                      ("nadam", "adam"), ("radam", "adam"),
                      ("nesterov", "sgd"), ("momentum", "sgd"),
                      ("fusedlamb", "lamb")):
    MPLUG_OPT_LAYOUTS[_alias] = MPLUG_OPT_LAYOUTS[_same]


def mplug_opt_layout(opt: str) -> Any:
    """The layout of `--opt` (any `<x>_` prefix dropped, as both factories
    drop it); a name outside the table raises "not yet ported"."""
    name = opt.lower().split("_")[-1]
    if name not in MPLUG_OPT_LAYOUTS:
        raise NotImplementedError(
            f"--opt {opt}: carrying its optimizer state across from the "
            "JAX package is not yet ported to crvqa_tpu_torch (ROADMAP)")
    return MPLUG_OPT_LAYOUTS[name]


def read_opt_layout(layout: Any, node: Any, what: str
                    ) -> tuple[int, dict[str, Any]]:
    """(count, {slot: the file's tree}) from one group's state `node`; a
    node that does not have the layout raises."""
    count: list[int] = []
    slots: dict[str, Any] = {}

    def walk(lay, nd, where):
        if isinstance(lay, _Slot):
            slots[str(lay)] = nd
        elif lay is _COUNT:
            count.append(int(np.asarray(nd)))
        elif lay is None or lay == {}:
            if not (nd is None if lay is None
                    else isinstance(nd, Mapping) and not nd):
                raise KeyError(f"{where}: {type(nd).__name__} where the "
                               f"layout has {lay!r}")
        else:
            if not isinstance(nd, Mapping) or set(nd) != set(lay):
                raise KeyError(
                    f"{where}: fields "
                    f"{sorted(nd) if isinstance(nd, Mapping) else nd!r:.60}"
                    f" where the layout has {sorted(lay)} (another --opt?)")
            for k in lay:
                walk(lay[k], nd[k], f"{where}/{k}")

    walk(layout, node, what)
    if len(set(count)) != 1:
        raise ValueError(f"{what}: counts {count} disagree")
    return count[0], slots


def write_opt_layout(layout: Any, count: int, slots: Mapping[str, Any]
                     ) -> Any:
    """`read_opt_layout` backwards: the group's state with `slots` and the
    count filled in."""
    if isinstance(layout, _Slot):
        return slots[str(layout)]
    if layout is _COUNT:
        return np.asarray(count, np.int32)
    if layout is None:
        return None
    return {k: write_opt_layout(v, count, slots) for k, v in layout.items()}


def _mplug_leaf(tree_key: tuple[str, ...], t: torch.Tensor, specs
                ) -> tuple[str, torch.Tensor]:
    """One leaf of a trainable tree (scores by spec key, head / params by
    path) -> the port's trainable name and layout. A leaf with the
    parameter's rank takes its layout; a vector or scalar beside it (a
    factored or per-leaf statistic) keeps its own."""
    if tree_key[0] == "scores":
        key = tree_key[1]
        return f"scores/{key}", _by_spec({key: t}, specs)[key]
    group, path = tree_key[0], tree_key[1:]
    name, perm = _mplug_name_layout(path)
    if path[-1] == "g" and t.numel() == 1:
        t = t.reshape(())
    elif perm is not None and t.dim() == len(perm):
        t = t.permute(perm)
    elif perm is not None and t.dim() > 1:
        raise NotImplementedError(f"{'/'.join(path)}: an optimizer slot of "
                                  f"rank {t.dim()} beside a rank-"
                                  f"{len(perm)} parameter")
    return f"{group}/{name}", t.contiguous()


def _mplug_transposes(tree_key: tuple[str, ...], specs) -> bool:
    """Whether the port stores the trainable leaf at `tree_key` (a path as
    `_mplug_leaf` takes it) as the transpose of the JAX package's 2-D
    leaf: a score of a dense layer's mask, or a kernel."""
    if tree_key[0] == "scores":
        spec = {s.key: s for s in specs or ()}.get(tree_key[1])
        return spec is not None and not spec.is_embedding
    return _mplug_name_layout(tree_key[1:])[1] == (1, 0)


def _swap_square_factors(slots: Mapping[str, Any], transposed
                         ) -> dict[str, Any]:
    """Adafactor's factored second moment carried between the layouts:
    optax's `_factored_dims` breaks the tie of a square leaf's two dims
    the same way in both packages (rows d1 = 0, columns d0 = 1), so where
    the port's [out, in] leaf is the JAX [in, out] leaf transposed, the
    port's v_row (indexed by `out`) is the JAX v_col and its v_col the
    JAX v_row. `slots` (slot -> {name: tensor}) with those two swapped for
    every square factored leaf whose name `transposed` holds; a new dict,
    the map being its own inverse. A leaf the JAX package leaves
    unfactored holds (1,) placeholders, a non-square one vectors of two
    sizes: neither is touched."""
    if "v_row" not in slots:
        return dict(slots)
    rows, cols = dict(slots["v_row"]), dict(slots["v_col"])
    for name in set(rows) & set(cols) & set(transposed):
        if rows[name].numel() > 1 and rows[name].shape == cols[name].shape:
            rows[name], cols[name] = cols[name], rows[name]
    return dict(slots, v_row=rows, v_col=cols)


def _mplug_trainable_from_jax(trees, mode: str, specs, transposed=None
                              ) -> dict[str, torch.Tensor]:
    """Trees over the JAX trainable tree (mask mode {"scores": {key: ...},
    "head": {'/'-path: ...}}, full mode the param tree), one per
    optimizer group, whose leaves of the other group are empty (optax's
    MaskedNode) or None -> one flat dict keyed like
    `mplug_train.trainable`. `transposed` (a set): collects the names of
    the leaves the port stores transposed (`_mplug_transposes`)."""
    out: dict[str, torch.Tensor] = {}

    def put(here, value):
        name, t = _mplug_leaf(here, _t(value), specs)
        if name in out:
            raise KeyError(f"{name}: in both optimizer groups")
        out[name] = t
        if transposed is not None and _mplug_transposes(here, specs):
            transposed.add(name)

    def walk(node, path):
        for key, value in node.items():
            here = path + tuple(key.split("/"))
            if isinstance(value, Mapping):
                walk(value, here)
            elif value is not None:
                put(here, value)

    for tree in trees:
        if mode == "mask":
            for key, value in tree["scores"].items():
                if value is not None and not isinstance(value, Mapping):
                    put(("scores", key), value)
            walk({"head": tree["head"]}, ())
        else:
            walk({"params": tree}, ())
    return out


def _mplug_trainable_to_jax(flat: Mapping[str, torch.Tensor], mode: str,
                            specs, model: torch.nn.Module,
                            keep=lambda name: True) -> dict[str, Any]:
    """`_mplug_trainable_from_jax` backwards for one group: the leaves
    `keep` selects in place, an empty dict (MaskedNode) for the rest."""
    by_key = {s.key: s for s in specs or ()}
    scores: dict[str, Any] = {}
    head: dict[str, Any] = {}
    params: dict[str, Any] = {}
    for name, t in flat.items():
        group, rest = name.split("/", 1)
        if group == "scores":
            spec = by_key.get(rest)
            if spec is not None and t.dim() == 2 and not spec.is_embedding:
                t = t.T
            scores[rest] = _out(t) if keep(name) else {}
            continue
        path = mplug_jax_path(rest, model)
        _, perm = _mplug_name_layout(path)
        if path[-1] == "g" and t.dim() == 0:
            t = t.reshape(1)
        elif perm is not None and t.dim() == len(perm):
            inverse = tuple(int(i) for i in np.argsort(perm))
            t = t.permute(inverse)
        leaf = _out(t) if keep(name) else {}
        if group == "head":
            head["/".join(path)] = leaf
        else:
            node = params
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = leaf
    if mode == "mask":
        return {"head": _sorted_tree(head), "scores": _sorted_tree(scores)}
    return _sorted_tree(params)


@torch.no_grad()
def mplug_state_from_jax(state, tree: Mapping[str, Any], config, specs=None
                         ) -> None:
    """A JAX `MPlugState` (crvqa_tpu/train/mplug_train.py:28-43) into a
    port `MPlugState` built by `mplug_train.init_state` with the same
    configuration (`config`, its `MPlugTrainConfig`; `specs` the masker's
    in mask mode). Every parameter (the frozen ones too: the file holds
    them all), scores and thresholds; in a training state also the
    momentum twins, the optimizer state by `--opt` (`MPLUG_OPT_LAYOUTS`,
    the two groups of `multi_transform` merged into the port's one flat
    dict), the key and the step. A serving state (no optimizer) takes
    the parameters, scores and thresholds only, as the JAX server does."""
    if "params_m" not in tree:
        raise _kind_error(tree, "mPLUG training state")
    _copy_leaves(state.params, mplug_state_dict_from_jax(tree["params"]),
                 "params")
    for suffix in ("", "_m"):
        dst = getattr(state, "scores" + suffix)
        if dst is None:
            continue
        if tree.get("scores" + suffix) is None:
            raise KeyError(f"scores{suffix}: not in the file (another "
                           "--mode or --distill?)")
        _copy_leaves(dst, _by_spec(tree["scores" + suffix], specs),
                     "scores" + suffix)
        dev = next(iter(dst.values())).device
        setattr(state, "thresholds" + suffix,
                {k: _t(v).float().to(dev)
                 for k, v in tree["thresholds" + suffix].items()})
    if state.scores is None and tree.get("scores") is not None:
        raise KeyError("scores: the file is a --mode mask state, the run "
                       "is --mode full")
    if state.opt_state is None:
        return
    if state.params_m is not None:
        if tree.get("params_m") is None:
            raise KeyError("params_m: not in the file (written without "
                           "--distill)")
        _copy_leaves(state.params_m,
                     mplug_state_dict_from_jax(tree["params_m"]),
                     "params_m")
    mplug_opt_state_from_jax(state.opt_state, tree["opt_state"], config.opt,
                             config.mode, specs)
    _rng_into(state, tree["rng"])
    state.step = int(tree["step"])


@torch.no_grad()
def mplug_opt_state_from_jax(port, opt: Mapping[str, Any], name: str,
                             mode: str, specs=None) -> None:
    """The JAX two-group optimizer state of `--opt name` (`opt`, the
    file's `opt_state`) into the port's (`GroupAdamW`'s `AdamWState`, or an
    `OptState` of `TwoGroupOptimizer` / `AdaHessian`), in place: each
    group's state read by `MPLUG_OPT_LAYOUTS`, the groups' slot trees
    merged into the port's flat dicts keyed like `mplug_train.trainable`
    (`mode` 'mask' or 'full'), the count."""
    layout = mplug_opt_layout(name)
    if name.lower().split("_")[-1] == "adahessian":
        count, slots = read_opt_layout(layout, opt, "opt_state")
        trees = {k: [v] for k, v in slots.items()}
    else:
        _empty(opt["0"], "opt_state/0")
        groups = opt["1"]["inner_states"]
        trees, counts = {}, set()
        for g in ("body", "visual"):
            count, slots = read_opt_layout(
                layout, groups[g]["inner_state"],
                f"opt_state/1/inner_states/{g}/inner_state")
            counts.add(count)
            for k, v in slots.items():
                trees.setdefault(k, []).append(v)
        if len(counts) != 1:
            raise ValueError(f"opt_state: group counts {sorted(counts)}")
    dst_slots = (port.slots if hasattr(port, "slots")
                 else {"mu": port.mu, "nu": port.nu})
    transposed: set[str] = set()
    flat = _swap_square_factors(
        {k: _mplug_trainable_from_jax(v, mode, specs, transposed)
         for k, v in trees.items()}, transposed)
    for slot, dst in dst_slots.items():
        src = flat[slot]
        if slot in ("v_row", "v_col", "v"):
            # the JAX state holds (1,) placeholders where the port has no
            # entry: a factored leaf's v, a plain leaf's v_row / v_col
            for k in set(src) - set(dst):
                if src[k].numel() != 1:
                    raise KeyError(f"opt_state/{slot}/{k}: not a "
                                   "placeholder")
                del src[k]
        _copy_leaves(dst, src, f"opt_state/{slot}", same_dtype=True)
    port.count = count


def _port_tree_key(name: str, model: torch.nn.Module) -> tuple[str, ...]:
    """A port trainable name ("scores/<key>", "params/<name>",
    "head/<name>") -> its path in the JAX trainable tree, as
    `_mplug_leaf` takes it."""
    group, rest = name.split("/", 1)
    if group == "scores":
        return ("scores", rest)
    return (group,) + mplug_jax_path(rest, model)


def jax_from_mplug_state(state, model: torch.nn.Module, config, specs=None
                         ) -> dict[str, Any]:
    """A port `MPlugState` (training) -> the JAX package's `MPlugState`
    tree, the optimizer state laid out by `--opt`."""
    from ..train.mplug_train import trainable, two_group_labels

    def params_tree(p):  # the JAX state's parameters are fp32
        return _mplug_trainable_to_jax(
            {f"params/{n}": t.float() if t.dtype == torch.bfloat16 else t
             for n, t in p.items()}, "full", specs, model)

    def scores(d):  # in the key order of the JAX package's files
        return None if d is None else _sorted_tree({
            k: _out(v) for k, v in _by_spec(d, specs or ()).items()})

    def thresholds(d):
        return None if d is None else _sorted_tree({
            k: _out(v.float()) for k, v in d.items()})

    layout = mplug_opt_layout(config.opt)
    port = state.opt_state
    slots = (port.slots if hasattr(port, "slots")
             else {"mu": port.mu, "nu": port.nu})
    slots = _swap_square_factors(slots, {
        name for name in slots.get("v_row", ())
        if _mplug_transposes(_port_tree_key(name, model), specs)})
    names = list(trainable(state, config))
    groups = two_group_labels(names)

    def filled(flat, keep):
        if flat and set(flat) != set(names):
            # adafactor: placeholders where the other factorization sits
            ref = next(iter(flat.values()))
            flat = {n: flat.get(n, torch.zeros(1, dtype=ref.dtype))
                    for n in names}
        return _mplug_trainable_to_jax(flat, config.mode, specs, model,
                                       keep)

    if config.opt.lower().split("_")[-1] == "adahessian":
        opt = write_opt_layout(layout, port.count, {
            k: filled(v, lambda n: True) for k, v in slots.items()})
    else:
        inner = {g: {"inner_state": write_opt_layout(layout, port.count, {
            k: filled(v, lambda n, g=g: groups[n] == g)
            for k, v in slots.items()})} for g in ("body", "visual")}
        opt = {"0": {}, "1": {"inner_states": inner}}
    return {"step": np.asarray(state.step, np.int32),
            "params": params_tree(state.params),
            "scores": scores(state.scores),
            "thresholds": thresholds(state.thresholds),
            "params_m": (None if state.params_m is None
                         else params_tree(state.params_m)),
            "opt_state": opt,
            "rng": state.rng.to_jax_key(),
            "scores_m": scores(state.scores_m),
            "thresholds_m": thresholds(state.thresholds_m)}
