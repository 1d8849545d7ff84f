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
from typing import Any, Sequence

import numpy as np
import torch

from ..masking.spec import MaskSpec


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


def load_mask_dict_bool(path: str) -> dict[str, np.ndarray]:
    """mask.pt -> {torch_name: bool ndarray}, every key it holds (what
    `evals.compare_mask` compares)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.numpy().astype(bool) for k, v in raw.items()}


def export_mask_pt(path: str, masks: dict[str, torch.Tensor],
                   specs: Sequence[MaskSpec]) -> None:
    """Write bool masks keyed by spec key, already in the torch orientation,
    as a reference-format `mask.pt`: {`<torch_name>.weight`: BoolTensor}
    (mask_trainer_Robust_VQA.py:943-991)."""
    torch.save({f"{spec.torch_name}.weight":
                masks[spec.key].detach().to("cpu", torch.bool).contiguous()
                for spec in specs}, path)


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
    it)."""
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
    missing = [k for k in template if k not in state]
    if missing:
        raise KeyError(f"missing keys in torch state_dict: {missing[:10]}"
                       f"{'...' if len(missing) > 10 else ''}")
    out = {}
    for name, t in template.items():
        arr = torch.as_tensor(state[name]).detach().to(t.dtype)
        if name.endswith("weight_g"):
            arr = arr.reshape(t.shape)
        if arr.shape != t.shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(t.shape)}")
        out[name] = arr
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
    of the JAX package), tensors on the CPU as they are held (fp32)."""
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
