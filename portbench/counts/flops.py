"""The model's work, counted on the benchmark's own plain reference: the
FLOPs of one step (training: forward and backward of the stage-2 step;
answering: the eval forward) and the attention calls it makes, at a
cell's shapes, by `torch.utils.flop_counter.FlopCounterMode` on the `meta`
device.

Products only (matmuls and attention's two products); no elementwise
work, no recompute, no padding, and nothing that reaches no output (the
reference skips LXMERT's last vision branch). The program's own count
(`crvqa_tpu_torch.utils.mfu.count_flops`) moves with the program; this
one moves only with the configuration and the traffic.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.common import Draws, learned_mixin_rows

def _meta_batch(family, cfg: dict, trf: dict, batch: int) -> dict:
    L, boxes = trf["question_tokens"]["max"], trf["boxes"]
    meta = dict(device="meta")
    out = {"input_ids": torch.zeros(batch, L, dtype=torch.long, **meta),
           "attention_mask": torch.ones(batch, L, **meta),
           "labels": torch.zeros(batch, cfg["ans_num"], **meta),
           "bias": torch.zeros(batch, cfg["ans_num"], **meta)}
    if family.STYLE == "visualbert":
        out["visual_embeds"] = torch.zeros(
            batch, boxes, cfg["visual_embedding_dim"], **meta)
    else:
        out["visual_feats"] = torch.zeros(batch, boxes,
                                          cfg["visual_feat_dim"], **meta)
        out["visual_pos"] = torch.zeros(batch, boxes, cfg["visual_pos_dim"],
                                        **meta)
    return out


def count_step(family, cfg: dict, trf: dict, train: bool,
               batch: int = None) -> tuple[int, list]:
    """(FLOPs, attention calls [(B, H, Sq, Sk, D, with backward)]) of one
    step of `batch` rows (default: the traffic's batch)."""
    n = batch or trf["batch_size"]
    ref = family.reference
    masked = {name for name, _ in ref.masked_weights(cfg)}
    trainable = masked | {name for name, _, _ in ref.param_table(cfg)
                          if name.startswith(ref.CLASSIFIER + ".")}
    p = {name: torch.zeros(shape, device="meta").requires_grad_(
             train and name in trainable)
         for name, shape, _ in ref.param_table(cfg)}
    b = _meta_batch(family, cfg, trf, n)
    lmh = {"bias_lin.weight": torch.zeros(1, cfg["hidden_size"],
                                          device="meta"),
           "bias_lin.bias": torch.zeros(1, device="meta"),
           "smooth_param": torch.zeros(1, device="meta")}
    calls: list = []
    with FlopCounterMode(display=False) as counter:
        with torch.set_grad_enabled(train):
            logits, pooled = ref.forward(
                p, b, cfg, Draws(None, None, slice(0, n), log=calls))
            if train:
                learned_mixin_rows(lmh, pooled, logits, b["bias"],
                                   b["labels"]).mean().backward()
    return int(counter.get_total_flops()), calls
