"""Stage-2 checkpoint / resume in the port's own torch format (counterpart
of `crvqa_tpu/core/checkpoint.py`, whose msgpack files the port does not
read yet).

A checkpoint holds what training changes: the step, mask scores,
thresholds, the classifier and LMH parameters, the optimizer state and
both generators' states. The frozen backbone is not stored: a resumed run
rebuilds it from the same `--stage1_ckpt` and `--seed`. Writes are atomic
(temporary file, then rename); `<path>.meta.json` carries the metadata.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path: str, state, metadata: Optional[dict] = None
                    ) -> None:
    opt = state.opt_state
    payload = {
        "step": state.step,
        "scores": state.scores,
        "thresholds": state.thresholds,
        "train_params": state.train_params,
        "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu,
                      "abs_grad_sum": opt.abs_grad_sum},
        "rng": {"device": state.rng.device.get_state(),
                "host": state.rng.host.get_state()},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_cpu(payload), tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f)


@torch.no_grad()
def load_checkpoint(path: str, state):
    """Copy a checkpoint into `state` (built by `stage2.init_state` with
    the same configuration) in place; returns it."""
    raw = torch.load(path, map_location="cpu", weights_only=True)

    def copy(dst: dict, src: dict, what: str) -> None:
        if set(dst) != set(src):
            raise KeyError(f"{path}: {what} keys differ from the run's "
                           f"({sorted(set(dst) ^ set(src))[:5]})")
        for k, t in src.items():
            dst[k].copy_(t)

    copy(state.scores, raw["scores"], "scores")
    state.thresholds = {k: t.to(state.scores[k].device)
                        for k, t in raw["thresholds"].items()}
    for group, params in raw["train_params"].items():
        copy(state.train_params[group], params, f"train_params/{group}")
    opt = raw["opt_state"]
    state.opt_state.count = opt["count"]
    copy(state.opt_state.mu, opt["mu"], "opt_state/mu")
    copy(state.opt_state.nu, opt["nu"], "opt_state/nu")
    if state.opt_state.abs_grad_sum is not None:
        copy(state.opt_state.abs_grad_sum, opt["abs_grad_sum"],
             "opt_state/abs_grad_sum")
    state.rng.device.set_state(raw["rng"]["device"])
    state.rng.host.set_state(raw["rng"]["host"])
    state.step = int(raw["step"])
    return state


def rotate_checkpoints(directory: str, keep: int, prefix: str = "ckpt_"
                       ) -> None:
    """Keep the newest `keep` checkpoints (`_rotate_checkpoints`,
    mask_trainer_Robust_VQA.py:1040-1052); keep <= 0 keeps all."""
    if keep <= 0 or not os.path.isdir(directory):
        return
    cands = sorted((int(n[len(prefix):]), os.path.join(directory, n))
                   for n in os.listdir(directory)
                   if n.startswith(prefix) and n[len(prefix):].isdigit())
    for _, path in cands[:-keep]:
        os.remove(path)
        if os.path.exists(path + ".meta.json"):
            os.remove(path + ".meta.json")
