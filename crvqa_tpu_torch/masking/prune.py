"""Stage-2 subnetwork pruning at load (counterpart of
`crvqa_tpu/masking/masker.py:Masker.prune_params` with
`crvqa_tpu/cli/common.py:lxmert_uniform_masker`).

The served weights are exactly `w * mask` (`run_vqa_stage3.py:227-324`'s
`pruning_model_with_mask`), folded in once at load, so no masked matmul
runs per request.
"""
from __future__ import annotations

import torch

from .spec import MaskSpec, lxmert_mask_specs


def lxmert_specs_for(config) -> list[MaskSpec]:
    """The mask table of an LXMERT config — the one `mask.pt` is read by."""
    return lxmert_mask_specs(config.l_layers, config.r_layers,
                             config.x_layers)


def prune_state_dict(state: dict[str, torch.Tensor],
                     masks: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
    """A copy of `state` with each masked weight replaced by `w * mask`
    (masks keyed by state_dict name, in the weight's own orientation)."""
    out = dict(state)
    for name, mask in masks.items():
        w = out[name]
        if mask.shape != w.shape:
            raise ValueError(f"{name}: mask shape {tuple(mask.shape)} != "
                             f"weight shape {tuple(w.shape)}")
        out[name] = w * mask.to(device=w.device, dtype=w.dtype)
    return out
