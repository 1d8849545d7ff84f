"""Reference checkpoint and artifact import and export (counterpart of
`crvqa_tpu/core/torch_compat.py`).

The reference's API is its files:
  - `mask.pt`: {`<torch_module_name>.weight`: BoolTensor}
    (`mask_trainer_Robust_VQA.py:943-991`);
  - `classifier4masker.bin`: the classifier module or its state_dict
    (`mask_trainer_Robust_VQA.py:734-740`), keys `main.0.*` / `main.3.*`;
  - stage-1/3 checkpoints: `torch.save(model)` whole-module pickles or
    state_dicts (the port writes state_dicts, `save_torch_state_dict`).

The port's parameter names ARE the reference names, so everything here
loads straight into state_dicts: no transposes, no renames. Whole-module
pickles load without the reference's class definitions through the stub
unpickler below.
"""
from __future__ import annotations

import dataclasses
import io
import pickle
import types
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..masking.spec import MaskSpec
from ..parallel.mesh import is_main_process


# ------------------------------------------------------------------- mask.pt

def import_mask_pt(path: str, specs: Sequence[MaskSpec]
                   ) -> dict[str, torch.Tensor]:
    """Read a reference `mask.pt`: {`<torch_name>.weight`: bool tensor} for
    every spec, in the reference orientation (the port's own)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    names = [f"{spec.torch_name}.weight" for spec in specs]
    missing = [n for n in names if n not in raw]
    if missing:
        raise KeyError(f"{path}: mask.pt lacks {missing[:10]}"
                       f"{'...' if len(missing) > 10 else ''}")
    return {n: raw[n].to(torch.bool) for n in names}


def _mask_names(spec: MaskSpec) -> list[str]:
    """A spec's mask.pt keys: one per layer of a stacked spec."""
    if spec.stacked:
        return [f"{spec.torch_name.format(i)}.weight"
                for i in range(spec.stacked)]
    return [f"{spec.torch_name}.weight"]


def load_mask_dict_bool(path: str) -> dict[str, np.ndarray]:
    """mask.pt -> {torch_name: bool ndarray}, every key it holds (what
    `evals.compare_mask` compares)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.numpy().astype(bool) for k, v in raw.items()}


def export_mask_pt(path: str, masks: dict[str, torch.Tensor],
                   specs: Sequence[MaskSpec]) -> None:
    """Write bool masks keyed by spec key, already in the torch orientation,
    as a reference-format `mask.pt`: {`<torch_name>.weight`: BoolTensor}
    (mask_trainer_Robust_VQA.py:943-991). A stacked spec (the scan layout)
    writes each layer under its unrolled name, a tensor of its own
    (crvqa_tpu/core/torch_compat.py:50-71), so both layouts write the same
    file. Rank 0 writes."""
    if not is_main_process():
        return
    out = {}
    for spec in specs:
        m = masks[spec.key].detach().to("cpu", torch.bool)
        layers = m.unbind(0) if spec.stacked else (m,)
        for name, layer in zip(_mask_names(spec), layers):
            out[name] = layer.clone(memory_format=torch.contiguous_format)
    torch.save(out, path)


def twin_mask_specs(specs: Sequence[MaskSpec]) -> list[MaskSpec]:
    """The momentum twins' names for `export_mask_pt`: every spec of a live
    module under `<tower>_m.` (the reference's mask.pt also carries the `_m`
    modules' masks, mPLUG/masking/maskers.py:80-84). Specs that are
    momentum-only already name a twin and are left out."""
    twins = []
    for s in specs:
        if s.momentum_only:
            continue
        tower, rest = s.torch_name.split(".", 1)
        twins.append(dataclasses.replace(
            s, path=(s.path[0] + "_m",) + s.path[1:],
            torch_name=f"{tower}_m.{rest}"))
    return twins


def export_classifier_bin(path: str, classifier: dict[str, torch.Tensor]
                          ) -> None:
    """Save the classifier's state_dict (`main.0.*` / `main.3.*`) as
    `classifier4masker.bin` (mask_trainer_Robust_VQA.py:734-740, the
    module pickle replaced by its state_dict, as the JAX package writes
    it). Rank 0 writes."""
    if not is_main_process():
        return
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous()
                for k, v in classifier.items()}, path)


# ------------------------------------------------------ checkpoints / .bin

def load_state_dict_file(path: str) -> dict[str, torch.Tensor]:
    """A `.bin`/`.pt`/`.pth` state_dict or whole-module pickle -> flat
    {name: tensor}. Falls back to the stub unpickler when the pickle names
    classes that are not importable (the reference's own)."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError):
        raw = module_pickle_state_dict(path)
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    return dict(raw)


def fill_state_dict(state: dict[str, Any], template: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """Every key of `template` taken from `state`, cast to the template's
    dtype; a missing key raises KeyError, a shape mismatch ValueError.
    Keys of `state` that the template lacks are ignored (the JAX package's
    `torch_state_dict_to_flax` rule)."""
    out, missing, _ = _fill_report(state, template)
    if missing:
        raise KeyError(f"missing keys in torch state_dict: {missing[:10]}"
                       f"{'...' if len(missing) > 10 else ''}")
    return out


def load_torch_params(path: str, template: dict[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """A reference checkpoint (a stage-1/3 model, or a
    `classifier4masker.bin` over a `main.*`-keyed classifier template) laid
    over `template`, a state_dict."""
    return fill_state_dict(load_state_dict_file(path), template)


def save_torch_state_dict(path: str, state: dict[str, torch.Tensor]) -> None:
    """torch.save a state_dict in the reference names (the stage-1 -> stage
    2/3 interop artifact, `<label4save>_FT*.bin`; `save_torch_state_dict`
    of the JAX package), tensors on the CPU as they are held (fp32). Rank
    0 writes."""
    if not is_main_process():
        return
    torch.save({k: v.detach().to("cpu").contiguous()
                for k, v in state.items()}, path)


# ----------------------------------------- stub-class whole-module unpickling
#
# The reference's checkpoints are whole-module pickles whose classes
# (`hg_transformers.modeling_lxmert.LxmertForMultipleChoice`, ...) are not
# importable here. The stub loader resolves only allowlisted roots and
# fabricates a state-capturing stand-in for every other class, then walks
# the reconstructed `_parameters`/`_buffers`/`_modules` dicts into a flat
# state_dict.

_STUB_ALLOWED_ROOTS = frozenset(
    {"torch", "builtins", "collections", "copyreg", "numpy", "_codecs",
     "functools", "argparse",
     # py2-era names in protocol<=2 GLOBAL opcodes
     "__builtin__", "copy_reg"})
_stub_class_cache: dict[tuple, type] = {}


class _StubObject:
    """Reconstruction target for classes we refuse to import: construction
    args are ignored; state lands in __dict__."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            d, slots = state
            state = {**(d or {}), **(slots or {})}
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_stub_state"] = state


def _stub_class(module: str, name: str) -> type:
    key = (module, name)
    cls = _stub_class_cache.get(key)
    if cls is None:
        cls = type(name, (_StubObject,), {"__module__": module})
        _stub_class_cache[key] = cls
    return cls


def _stub_pickle_module():
    """A `pickle_module` for torch.load whose Unpickler stubs every class
    outside the allowlist (torch keeps its own storage handling)."""

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".", 1)[0] in _STUB_ALLOWED_ROOTS:
                return super().find_class(module, name)
            return _stub_class(module, name)

    mod = types.ModuleType("crvqa_stub_pickle")
    mod.Unpickler = StubUnpickler
    mod.load = lambda f, **kw: StubUnpickler(f, **kw).load()
    mod.loads = lambda s, **kw: StubUnpickler(io.BytesIO(s), **kw).load()
    mod.Pickler = pickle.Pickler
    mod.HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
    return mod


def _walk_module_state(obj: Any, prefix: str, out: dict) -> None:
    """nn.Module.state_dict recursion over a (possibly stubbed) module tree."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for name, t in (d.get("_parameters") or {}).items():
        if t is not None:
            out[prefix + name] = t
    non_persistent = d.get("_non_persistent_buffers_set") or ()
    for name, t in (d.get("_buffers") or {}).items():
        if t is not None and name not in non_persistent:
            out[prefix + name] = t
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            _walk_module_state(child, prefix + name + ".", out)


def module_pickle_state_dict(path: str) -> dict[str, Any]:
    """torch.load any checkpoint without importing its classes; a uniform
    `module.` prefix (DataParallel saves) is stripped."""
    raw = torch.load(path, map_location="cpu",
                     pickle_module=_stub_pickle_module(), weights_only=False)
    if isinstance(raw, dict):
        state = dict(raw)
    else:
        state = {}
        _walk_module_state(raw, "", state)
        if not state:
            raise ValueError(
                f"{path}: unpickled object of type {type(raw).__name__} "
                "carries no _parameters/_buffers/_modules tree")
    if state and all(k.startswith("module.") for k in state):
        state = {k[len("module."):]: v for k, v in state.items()}
    return state


# ------------------------------------------- mPLUG pretrained-checkpoint import
#
# The reference starts mPLUG from a downloaded torch checkpoint
# (`mPLUG/vqa_mplug.py:338-376`): a `model`/`module` unwrap, a bilinear
# resize of the visual positional embedding to the configured resolution,
# a `fusion.`/`bert.` key shim for pretraining-format checkpoints, and
# `load_state_dict(strict=False)`. The functions below run that pipeline
# into the port's state_dict (the counterpart of
# `crvqa_tpu/core/torch_compat.py:419-585`). The port's names ARE the
# reference's, so the key remap only drops what the model has no parameter
# for.

_MPLUG_TOWERS = ("visual_encoder", "text_encoder", "fusion_encoder",
                 "text_decoder", "visn_fc", "visn_layer_norm")
_POS_EMBED = "visual_encoder.visual.positional_embedding"


def resize_pos_embed_np(pos, new_len: int) -> torch.Tensor:
    """`models/visual_transformers.py:resize_pos_embed` (:19-38): the class
    token kept, the square patch grid resized bilinearly to `new_len - 1`
    positions. fp32 on the CPU, before any cast or device move, so the
    result is bit-equal to the JAX package's (the same F.interpolate)."""
    pos = torch.as_tensor(np.asarray(pos, np.float32)
                          if not isinstance(pos, torch.Tensor) else pos)
    pos = pos.detach().to("cpu", torch.float32)
    if pos.shape[0] == new_len:
        return pos
    tok, grid = pos[:1], pos[1:]
    gs_old = int(round(len(grid) ** 0.5))
    gs_new = int(round((new_len - 1) ** 0.5))
    g = grid.contiguous().reshape(1, gs_old, gs_old, -1).permute(0, 3, 1, 2)
    g = torch.nn.functional.interpolate(g, size=(gs_new, gs_new),
                                        mode="bilinear")
    g = g.permute(0, 2, 3, 1).reshape(gs_new * gs_new, -1)
    return torch.cat([tok, g], 0)


def strip_fusion_bert_keys(sd: dict[str, Any]) -> dict[str, Any]:
    """The reference's pretraining-format key shim with its exact dict
    semantics (`vqa_mplug.py:367-371`): every key holding 'fusion' or
    'bert' but not 'decode' is re-keyed at `key.replace('fusion.', '')
    .replace('bert.', '')`, and a key whose rename equals itself is
    DELETED (set, then del, of the same name)."""
    sd = dict(sd)
    for key in list(sd.keys()):
        if ("fusion" in key or "bert" in key) and "decode" not in key:
            encoder_key = key.replace("fusion.", "").replace("bert.", "")
            sd[encoder_key] = sd[key]
            del sd[key]
    return sd


def _mplug_remap_key(key: str) -> Optional[str]:
    """A reference mPLUG parameter name -> the port's name (the same one),
    or None for what the model has no parameter for: the CLIP text tower
    and `logit_scale` (everything under `visual_encoder.` but `visual.`),
    `visual.proj` (never applied with skip_last_layer), the tied
    `cls.predictions.decoder`, `position_ids` buffers, and any other
    module (the beam generator's)."""
    tower = key.split(".", 1)[0]
    if tower == "visual_encoder":
        if not key.startswith("visual_encoder.visual."):
            return None
        return None if key == "visual_encoder.visual.proj" else key
    if tower in ("text_encoder", "fusion_encoder", "text_decoder"):
        if key.endswith("position_ids") or key.startswith(
                "text_decoder.cls.predictions.decoder"):
            return None
        return key
    return key if tower in ("visn_fc", "visn_layer_norm") else None


def _fill_report(state: dict[str, Any], template: dict[str, torch.Tensor]
                 ) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """(template filled from `state` where it has the key, cast to the
    template's dtype; missing template names; used state names). A shape
    mismatch raises ValueError; a weight-norm `weight_g` takes the
    template's shape."""
    out, missing, used = {}, [], []
    for name, t in template.items():
        if name not in state:
            missing.append(name)
            out[name] = t
            continue
        used.append(name)
        arr = torch.as_tensor(state[name]).detach().to(dtype=t.dtype)
        if name.endswith("weight_g"):
            arr = arr.reshape(t.shape)
        if arr.shape != t.shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(t.shape)}")
        out[name] = arr
    return out, missing, used


def load_mplug_torch_checkpoint(
        path: str, template: dict[str, torch.Tensor],
        template_m: Optional[dict[str, torch.Tensor]] = None,
        pretrain_format: bool = True,
) -> tuple[dict[str, torch.Tensor], Optional[dict[str, torch.Tensor]],
           dict[str, list]]:
    """A reference-format mPLUG checkpoint laid over `template` (the
    port's fp32 state_dict on the CPU), as `mPLUG/vqa_mplug.py:338-376`
    loads it: `model` unwrapped first, then `module` (a whole-module
    pickle is read through `module_pickle_state_dict`); under
    `pretrain_format` (the reference's `not evaluate and not do_mask`
    gate) the positional embeddings of the tower and its `_m` twin are
    resized to the template's length and the `fusion.`/`bert.` shim
    applies; then a strict=False fill of the template and, when the
    checkpoint carries `_m` twins and `template_m` is given, of the twins'.

    Returns (params, params_m or None, report): `missing` template names
    the checkpoint did not cover (`missing_m` for the twins) and `unused`
    checkpoint keys nothing consumed, the JAX function's report."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError):
        raw = {"model": module_pickle_state_dict(path)}
    if isinstance(raw, dict) and ("model" in raw or "module" in raw):
        sd = raw.get("model", raw.get("module"))
    else:
        sd = raw.state_dict() if hasattr(raw, "state_dict") else raw
    sd = {k: (v.detach() if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v))) for k, v in sd.items()}
    if pretrain_format:
        new_len = template[_POS_EMBED].shape[0]
        for k in (_POS_EMBED, _POS_EMBED.replace("visual_encoder.",
                                                 "visual_encoder_m.")):
            if k in sd:
                sd[k] = resize_pos_embed_np(sd[k], new_len)
        sd = strip_fusion_bert_keys(sd)

    main, twin, unmapped = {}, {}, []
    for k, v in sd.items():
        tower = k.split(".", 1)[0]
        is_twin = tower.endswith("_m") and tower[:-2] in _MPLUG_TOWERS
        name = _mplug_remap_key(tower[:-2] + k[len(tower):] if is_twin
                                else k)
        if name is None:
            unmapped.append(k)
        else:
            (twin if is_twin else main)[name] = v
    params, missing, used = _fill_report(main, template)
    report = {"missing": missing,
              "unused": sorted(set(main) - set(used)) + unmapped}
    params_m = None
    if template_m is not None and twin:
        params_m, missing_m, used_m = _fill_report(twin, template_m)
        report["missing_m"] = missing_m
        report["unused"] += sorted(set(twin) - set(used_m))
    return params, params_m, report
