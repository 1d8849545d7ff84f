"""Shared CLI plumbing (the slice of `crvqa_tpu/cli/common.py` the server
uses)."""
from __future__ import annotations

import argparse
from typing import Optional

import torch


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def add_kernel_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' attention-kernel switches, parsed so the same argv
    works on both packages. In the port they select nothing: on the card
    the fused-attention kernel always runs where its scope admits the
    shape."""
    p.add_argument("--fused_attention", type=str2bool, default=False,
                   help="accepted for argv compatibility; the port always "
                        "runs its attention kernel")
    p.add_argument("--midseq_attention", type=str2bool, default=False,
                   help="accepted for argv compatibility; not yet ported")


def load_params_any(path: Optional[str], state: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """Overlay a params checkpoint onto `state` (a state_dict): reference
    torch artifacts (`.bin`/`.pt`/`.pth` state_dicts or whole-model
    pickles). The JAX package's msgpack checkpoint dirs are not yet
    ported."""
    if path is None:
        return state
    if path.endswith((".bin", ".pt", ".pth")):
        from ..core import torch_compat

        return torch_compat.load_torch_params(path, state)
    raise NotImplementedError(
        f"{path}: msgpack checkpoint directories are not yet ported to "
        "crvqa_tpu_torch (ROADMAP); pass a .bin/.pt/.pth checkpoint")


def overlay_classifier(state: dict[str, torch.Tensor], classifier_bin: str,
                       key: str = "classifier") -> dict[str, torch.Tensor]:
    """Swap in the stage-2 classifier (`classifier4masker.bin`,
    mask_trainer_Robust_VQA.py:734-740)."""
    from ..core import torch_compat

    prefix = key + "."
    template = {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}
    head = torch_compat.load_torch_params(classifier_bin, template)
    out = dict(state)
    out.update({prefix + k: v for k, v in head.items()})
    return out
