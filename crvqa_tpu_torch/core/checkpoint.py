"""Checkpoint / resume in the port's own torch format, and the JAX
package's msgpack parameter files (counterpart of
`crvqa_tpu/core/checkpoint.py`).

A checkpoint holds what training changes. Stage 2 (`save_checkpoint`): the
step, mask scores, thresholds, the classifier and LMH parameters, the
optimizer state and both generators' states. Stages 1 and 3
(`save_stage1_checkpoint`): the step, every parameter, the LMH parameters,
the optimizer state and the generators. mPLUG
(`save_mplug_checkpoint`): the step, the trained parameters (the LM head in
mask mode, everything in full mode), scores, thresholds, the momentum
twins, the optimizer state and the generators. The frozen backbone is not
stored: a resumed or serving run rebuilds it from the same checkpoint or
`--seed`. Writes are atomic (temporary file, then rename);
`<path>.meta.json` carries the metadata.

`save_msgpack` / `load_msgpack` write and read a tree in the JAX package's
format (`flax.serialization.to_bytes`, through the port's own codec
`core/msgpack.py`): the parameter files its stage 1 writes beside the
`.bin` and its stage 3 writes alone. Its `ckpt_<step>` / `ckpt_final`
training states are msgpack files too: `checkpoint_format` tells the two
kinds of file apart, `load_jax_training_state` reads such a state and
`save_jax_training_state` writes one; `core/convert.py` maps it onto the
port's states and back, and `cli/common.resume_any` picks the reader.

Under a process group the saves are collective: every rank calls them
together, a ZeRO-sharded optimizer state is gathered (`zero`, a
`parallel.zero.ZeroPartition`), rank 0 alone writes, and every rank waits
for the write before it goes on. The file is the one-device run's, and
any world size resumes it; tensor-parallel slices are gathered too.
"""
from __future__ import annotations

import dataclasses

import json
import os
import zipfile
from typing import Any, Optional

import torch

from ..parallel.mesh import barrier, is_main_process
from . import msgpack


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _write(path: str, payload: dict, metadata: Optional[dict]) -> None:
    if is_main_process():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(_cpu(payload), tmp)
        os.replace(tmp, path)
        if metadata is not None:
            with open(path + ".meta.json", "w") as f:
                json.dump(metadata, f)
    barrier()


def _full_opt_state(opt, zero):
    """The whole optimizer state: gathered over the data group when `zero`
    shards it."""
    return opt if zero is None else zero.gather_state(opt)


def save_msgpack(path: str, tree, metadata: Optional[dict] = None) -> None:
    """Write `tree` (nested dicts of numpy arrays or tensors) as the JAX
    package's `save_checkpoint` does: msgpack to `<path>.tmp`, renamed
    over `path` (a preempted write never leaves a torn file), and
    `<path>.meta.json` with the metadata. Rank 0 writes; every rank waits
    for it."""
    if is_main_process():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            msgpack.pack(tree, f)
        os.replace(tmp, path)
        if metadata is not None:
            with open(path + ".meta.json", "w") as f:
                json.dump(metadata, f)
    barrier()


def load_msgpack(path: str) -> Any:
    """A msgpack file of the JAX package's as a nested dict: numpy arrays,
    bfloat16 leaves as `torch.bfloat16` tensors (`core/msgpack.py`)."""
    return msgpack.read_file(path)


def checkpoint_format(path: str) -> str:
    """'port' for a checkpoint this port wrote (torch.save writes a zip
    archive), 'jax' for the JAX package's (a msgpack map,
    flax.serialization); anything else raises."""
    if zipfile.is_zipfile(path):
        return "port"
    with open(path, "rb") as f:
        head = f.read(1)
    # a non-empty map (0x80, the empty one, also opens a pickle)
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "jax"
    raise ValueError(f"{path}: neither a checkpoint of this port (a zip "
                     "archive) nor the JAX package's (a msgpack map)")


def load_jax_training_state(path: str) -> dict:
    """The JAX package's `ckpt_<step>` / `ckpt_final` as a nested dict
    (numpy arrays, bfloat16 leaves as `torch.bfloat16` tensors, the
    optimizer's tuples as dicts keyed "0", "1", ...). A msgpack file
    without the step and the optimizer state (a params file) raises."""
    tree = load_msgpack(path)
    if not (isinstance(tree, dict) and {"step", "opt_state"} <= set(tree)):
        raise ValueError(f"{path}: not a training state of the JAX package "
                         "(no step / opt_state); a params file goes to "
                         "--stage1_ckpt, --init_ckpt or serve_vqa --ckpt")
    return tree


def save_jax_training_state(path: str, tree: dict,
                            metadata: Optional[dict] = None) -> None:
    """Write a training state in the JAX package's layout (built by
    `core/convert.jax_from_*_state`) as its `save_checkpoint` does:
    msgpack to `<path>.tmp`, renamed over `path`, and `<path>.meta.json`;
    its `load_checkpoint` reads the file into the state template of the
    same run configuration."""
    if not {"step", "opt_state"} <= set(tree):
        raise ValueError("a training state holds step and opt_state")
    save_msgpack(path, tree, metadata)


def _read(path: str) -> dict:
    if checkpoint_format(path) != "port":
        raise ValueError(f"{path}: the JAX package's training state; read "
                         "it with load_jax_training_state and carry it "
                         "over with core/convert.py (cli/common.resume_any "
                         "does both)")
    return torch.load(path, map_location="cpu", weights_only=True)


def _copy(path: str, dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{path}: {what} keys differ from the run's "
                       f"({sorted(set(dst) ^ set(src))[:5]})")
    for k, t in src.items():
        if dst[k].shape != t.shape:
            # copy_ would broadcast a structured run's () or (H,) gate
            raise ValueError(f"{path}: {what}/{k} has shape "
                             f"{tuple(t.shape)}, the run's "
                             f"{tuple(dst[k].shape)}")
        dst[k].copy_(t)


def save_checkpoint(path: str, state, metadata: Optional[dict] = None,
                    zero=None, tp=None) -> None:
    """A `stage2.Stage2State` (collective under a process group; `tp`, a
    `parallel.tp.TensorParallel`, gathers the split scores and moments)."""
    opt = _full_opt_state(state.opt_state, zero)
    scores = state.scores
    if tp is not None:
        scores = tp.gather(scores)
        opt = dataclasses.replace(
            opt, mu=tp.gather(opt.mu), nu=tp.gather(opt.nu),
            abs_grad_sum=(None if opt.abs_grad_sum is None
                          else tp.gather(opt.abs_grad_sum)))
    payload = {
        "step": state.step,
        "scores": scores,
        "thresholds": state.thresholds,
        "train_params": state.train_params,
        "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu,
                      "abs_grad_sum": opt.abs_grad_sum},
        "rng": {"device": state.rng.device.get_state(),
                "host": state.rng.host.get_state()},
    }
    _write(path, payload, metadata)


@torch.no_grad()
def load_checkpoint(path: str, state):
    """Copy a checkpoint into `state` (built by `stage2.init_state` with
    the same configuration) in place; returns it."""
    raw = _read(path)

    _copy(path, state.scores, raw["scores"], "scores")
    state.thresholds = {k: t.to(state.scores[k].device)
                        for k, t in raw["thresholds"].items()}
    for group, params in raw["train_params"].items():
        _copy(path, state.train_params[group], params, f"train_params/{group}")
    opt = raw["opt_state"]
    state.opt_state.count = opt["count"]
    _copy(path, state.opt_state.mu, opt["mu"], "opt_state/mu")
    _copy(path, state.opt_state.nu, opt["nu"], "opt_state/nu")
    if state.opt_state.abs_grad_sum is not None:
        _copy(path, state.opt_state.abs_grad_sum, opt["abs_grad_sum"],
             "opt_state/abs_grad_sum")
    state.rng.device.set_state(raw["rng"]["device"])
    state.rng.host.set_state(raw["rng"]["host"])
    state.step = int(raw["step"])
    return state


def save_mplug_checkpoint(path: str, state, metadata: Optional[dict] = None,
                          zero=None) -> None:
    """An `mplug_train.MPlugState` (training or serving): its trained
    parameters are the leaves that require gradients (collective under a
    process group)."""
    opt = (None if state.opt_state is None
           else _full_opt_state(state.opt_state, zero))
    payload = {
        "step": state.step,
        "params": {k: v for k, v in state.params.items() if v.requires_grad},
        "scores": state.scores, "thresholds": state.thresholds,
        "params_m": state.params_m, "scores_m": state.scores_m,
        "thresholds_m": state.thresholds_m,
        "opt_state": (None if opt is None else
                      {f.name: getattr(opt, f.name)
                       for f in dataclasses.fields(opt)}),
        "rng": (None if state.rng is None else
                {"device": state.rng.device.get_state(),
                 "host": state.rng.host.get_state()}),
    }
    _write(path, payload, metadata)


@torch.no_grad()
def load_mplug_checkpoint(path: str, state):
    """Copy an mPLUG checkpoint into `state` in place; returns it. `state`
    is a training state built by `mplug_train.init_state(..., train=True)`
    with the same configuration (a resume: everything is restored), or a
    serving state (the trained parameters, scores and thresholds only, as
    the JAX server drops the rest)."""
    raw = _read(path)
    missing = sorted(set(raw["params"]) - set(state.params))
    if missing:
        raise KeyError(f"{path}: parameters {missing[:5]} are not the "
                       "model's")
    for k, t in raw["params"].items():
        state.params[k].copy_(t)
    if (raw["scores"] is None) != (state.scores is None):
        raise KeyError(f"{path}: the checkpoint's --mode differs from the "
                       "run's")
    for suffix in ("", "_m"):
        dst = getattr(state, "scores" + suffix)
        if dst is None:
            continue
        if raw["scores" + suffix] is None:
            raise KeyError(f"{path}: no scores{suffix} (written without "
                           "--distill)")
        _copy(path, dst, raw["scores" + suffix], "scores" + suffix)
        dev = next(iter(dst.values())).device
        setattr(state, "thresholds" + suffix,
                {k: t.to(dev) for k, t in raw["thresholds" + suffix].items()})
    if state.params_m is not None:
        if raw["params_m"] is None:
            raise KeyError(f"{path}: no momentum twins (written without "
                           "--distill)")
        _copy(path, state.params_m, raw["params_m"], "params_m")
    if state.opt_state is not None:
        _copy_opt_state(path, state.opt_state, raw["opt_state"])
    if state.rng is not None:
        state.rng.device.set_state(raw["rng"]["device"])
        state.rng.host.set_state(raw["rng"]["host"])
    state.step = int(raw["step"])
    return state


def _copy_opt_state(path: str, opt, raw: dict) -> None:
    """An optimizer state's fields from a checkpoint: the count, and every
    dict of tensors (a slot dict's dicts one by one) copied in place. A
    checkpoint of another `--opt` has other fields and is refused."""
    names = {f.name for f in dataclasses.fields(opt)}
    if set(raw) != names:
        raise KeyError(f"{path}: optimizer state {sorted(raw)}, the run's "
                       f"{sorted(names)} (another --opt?)")
    opt.count = raw["count"]
    for name in names - {"count"}:
        dst, src = getattr(opt, name), raw[name]
        if src and all(isinstance(v, dict) for v in src.values()):
            if set(dst) != set(src):
                raise KeyError(f"{path}: opt_state/{name} slots differ "
                               "from the run's (another --opt?)")
            for slot in src:
                _copy(path, dst[slot], src[slot], f"opt_state/{name}/{slot}")
        else:
            _copy(path, dst, src, f"opt_state/{name}")


def save_stage1_checkpoint(path: str, state,
                           metadata: Optional[dict] = None) -> None:
    """A `stage1.Stage1State` (stage 1 or 3): the step, every parameter,
    the LMH parameters, the optimizer state and the generators. Stage 3's
    constant masks are rebuilt from the run's arguments. Collective under
    a process group (rank 0 writes)."""
    opt = state.opt_state
    payload = {
        "step": state.step, "params": state.params,
        "lmh_params": state.lmh_params,
        "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
        "rng": {"device": state.rng.device.get_state(),
                "host": state.rng.host.get_state()},
    }
    _write(path, payload, metadata)


@torch.no_grad()
def load_stage1_checkpoint(path: str, state):
    """Copy a stage-1/3 checkpoint into `state` (built by
    `stage1.init_state` with the same configuration) in place; returns
    it."""
    raw = _read(path)
    _copy(path, state.params, raw["params"], "params")
    if state.lmh_params is not None:
        _copy(path, state.lmh_params, raw["lmh_params"], "lmh_params")
    opt = raw["opt_state"]
    state.opt_state.count = opt["count"]
    _copy(path, state.opt_state.mu, opt["mu"], "opt_state/mu")
    _copy(path, state.opt_state.nu, opt["nu"], "opt_state/nu")
    state.rng.device.set_state(raw["rng"]["device"])
    state.rng.host.set_state(raw["rng"]["host"])
    state.step = int(raw["step"])
    return state


def rotate_checkpoints(directory: str, keep: int, prefix: str = "ckpt_"
                       ) -> None:
    """Keep the newest `keep` checkpoints (`_rotate_checkpoints`,
    mask_trainer_Robust_VQA.py:1040-1052); keep <= 0 keeps all. Rank 0
    only."""
    if keep <= 0 or not os.path.isdir(directory) or not is_main_process():
        return
    cands = sorted((int(n[len(prefix):]), os.path.join(directory, n))
                   for n in os.listdir(directory)
                   if n.startswith(prefix) and n[len(prefix):].isdigit())
    for _, path in cands[:-keep]:
        os.remove(path)
        if os.path.exists(path + ".meta.json"):
            os.remove(path + ".meta.json")
