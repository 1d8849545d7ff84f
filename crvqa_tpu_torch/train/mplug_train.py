"""mPLUG state and answer generation (counterpart of the serving half of
`crvqa_tpu/train/mplug_train.py`; the training step, its optimizer and
schedules wait for the training slice).

The model is built on the meta device and never holds weights: every call
runs `torch.func.functional_call` on the state's parameter dict with each
masked weight replaced by `w * binarize(s, t)` (`Masker.apply_masks`), as
stage 2 does. One reparametrisation covers a whole call (encode, the cross
K/V projections and the beam loop), through `MPlug.forward(fn, ...)`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import functional_call

from ..masking.masker import Masker
from ..models.mplug import MPlug
from ..models.mplug.generator import (beam_generate, init_self_caches,
                                      precompute_cross_kv)


@dataclasses.dataclass(frozen=True)
class MPlugTrainConfig:
    mode: str = "mask"  # 'full' | 'mask'
    distill: bool = False


@dataclasses.dataclass
class MPlugState:
    """`params`: every parameter by state_dict name, on the device, in the
    model's dtypes; `scores` / `thresholds` by spec key (mask mode), scores
    [out, in] fp32."""

    params: dict[str, torch.Tensor]
    scores: Optional[dict[str, torch.Tensor]] = None
    thresholds: Optional[dict[str, torch.Tensor]] = None


def init_state(model: torch.nn.Module, params: dict[str, torch.Tensor],
               config: MPlugTrainConfig, device,
               masker: Optional[Masker] = None, seed: int = 0
               ) -> MPlugState:
    """A serving state from a full fp32 state_dict: in mask mode the scores
    and thresholds come from the fp32 weights (`masker.init`, as the JAX
    package inits them from its fp32 params; the random inits draw from a
    generator seeded with `seed`); the parameters are then cast to the
    dtypes the model computes with."""
    device = torch.device(device)
    params = {k: v.to(device) for k, v in params.items()}
    scores = thresholds = None
    if config.mode == "mask":
        if masker is None:
            raise ValueError("mask mode needs a masker")
        scores, thresholds = masker.init(
            params, torch.Generator(device=device).manual_seed(seed))
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    return MPlugState(params={n: t.to(dtypes[n]) for n, t in params.items()},
                      scores=scores, thresholds=thresholds)


def masked_params(masker: Optional[Masker], state: MPlugState
                  ) -> dict[str, torch.Tensor]:
    if masker is None or state.scores is None:
        return state.params
    return masker.apply_masks(state.params, state.scores, state.thresholds)


def run_masked(model: torch.nn.Module, masker: Optional[Masker],
               state: MPlugState, fn: Callable, *args):
    """fn(model, *args) in eval mode, without autograd, on the state's
    masked parameters."""
    model.eval()
    with torch.inference_mode():
        return functional_call(model, masked_params(masker, state),
                               (fn, *args), strict=True)


def make_generate_step(model: torch.nn.Module, config: MPlugTrainConfig,
                       masker: Optional[Masker] = None, beam_size: int = 5,
                       max_len: int = 12, min_length: int = 1,
                       lp_alpha: float = 0.6,
                       use_cache: bool = True) -> Callable:
    """generate(state, batch) -> (best ids [B, max_len], best scores [B]):
    beam search (`vqa_mplug.py:247-287`) over the fused states, the cross
    K/V projected once from the unreplicated memory and each item's beams
    grouped over it (`memory_groups`); `use_cache` decodes incrementally
    with self-attention KV caches. `batch` holds device tensors "images",
    "question_ids", "question_mask"."""
    mcfg = model.config
    bc = mcfg.bert

    def run(m, images, question_ids, question_mask):
        states, state_mask = m.encode(images, question_ids, question_mask)
        cross_kv = precompute_cross_kv(m.text_decoder, states,
                                       bc.text_decode_layers,
                                       bc.num_attention_heads, bc.head_size,
                                       dtype=bc.dtype)

        def decode(ids, mask, st, st_mask, position):
            return m.decode_logits(ids, mask, st, st_mask, cross_kv=cross_kv,
                                   position=position,
                                   memory_groups=beam_size)

        decode_step = init_caches = None
        if use_cache:
            init_caches = init_self_caches(
                states.shape[0] * beam_size, bc.text_decode_layers, max_len,
                bc.num_attention_heads, bc.head_size, dtype=bc.dtype,
                device=states.device)

            def decode_step(ids, st, st_mask, position, caches):
                return m.decode_logits_step(ids, st, st_mask, position,
                                            caches, cross_kv=cross_kv,
                                            memory_groups=beam_size)

        return beam_generate(decode, states, state_mask,
                             beam_size=beam_size, max_len=max_len,
                             bos=mcfg.bos_token_id, eos=mcfg.eos_token_id,
                             pad=mcfg.pad_token_id, min_length=min_length,
                             lp_alpha=lp_alpha, group_memory=True,
                             decode_step=decode_step,
                             init_caches=init_caches)

    def generate(state: MPlugState, batch: dict):
        mask = masker if config.mode == "mask" else None
        return run_masked(model, mask, state, run, batch["images"],
                          batch["question_ids"], batch["question_mask"])

    return generate


def mplug_meta_model(config) -> torch.nn.Module:
    """The mPLUG module on the meta device: structure and dtypes only."""
    with torch.device("meta"):
        return MPlug(config)
