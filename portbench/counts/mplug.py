"""mPLUG's work, counted on the benchmark's own plain reference
(`reference/mplug.py`): the FLOPs of one mask-training step (the forward,
the loss and the backward to every score and LM-head leaf) at a cell's
shapes, and the attention calls it makes, by
`torch.utils.flop_counter.FlopCounterMode` on the `meta` device.

Products only (every matmul, the attention's two products, the patch
embedding and the tied LM head); no elementwise work, no recompute, no
padding. The decoder's cross-attention is counted at its grouped shape,
(B, H, A*L, 1 + P + Lq), with each question's memory projected once, as
the program runs it. This count moves only with the configuration and
the traffic.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import mplug as ref


def meta_batch(cfg: dict, trf: dict, batch: int) -> dict:
    res, lq = cfg["image_res"], trf["question_tokens"]["max"]
    a, length = trf["answers"]["slots"], trf["answers"]["tokens"]
    meta = dict(device="meta")
    return {"images": torch.zeros(batch, res, res, 3, dtype=torch.uint8,
                                  **meta),
            "question_ids": torch.zeros(batch, lq, dtype=torch.long, **meta),
            "question_mask": torch.ones(batch, lq, **meta),
            "answer_ids": torch.zeros(batch, a, length, dtype=torch.long,
                                      **meta),
            "answer_mask": torch.ones(batch, a, length, **meta),
            "weights": torch.zeros(batch, a, **meta),
            "bias": torch.zeros(batch, a, **meta)}


def count_step(cfg: dict, trf: dict, batch: int = None
               ) -> tuple[int, list]:
    """(FLOPs, attention calls [(B, H, Sq, Sk, D, with backward)]) of one
    training step of `batch` questions (default: the traffic's batch)."""
    n = batch or trf["batch_size"]
    trainable = ({name for name, _ in ref.masked_weights(cfg)}
                 | set(ref.head_params(cfg)))
    p = {name: torch.zeros(shape, device="meta").requires_grad_(
             name in trainable)
         for name, shape, _ in ref.param_table(cfg)}
    calls: list = []
    with FlopCounterMode(display=False) as counter:
        loss = ref.loss_sum(p, meta_batch(cfg, trf, n), cfg,
                            ref.Replay(None, None, log=calls), batch_size=n)
        (loss / n).backward()
    return int(counter.get_total_flops()), calls
