"""Plain PyTorch VisualBERT for VQA (Li et al., 2019, arXiv:1908.03557; the
layout of `uclanlp/visualbert-vqa-coco-pre` with the VQA head of the
Compress-Robust-VQA reference).

One BERT stack over the question's tokens followed by the image's boxes:
word + position + token-type embeddings for the text, a projection of
each box's features plus visual position 0 and visual token type 1 for
the boxes, one LayerNorm over the joint sequence; a first-token pooler, a
hidden dropout and the weight-normalised classifier named `cls`.
Parameter names are the published PyTorch names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import FP32, Draws, Precision, additive_bias, layer_norm, linear
from .lxmert import _Blocks, classifier_table, classify

PREFIX = "visual_bert"
CLASSIFIER = "cls"


def masked_weights(cfg: dict) -> list[tuple[str, str]]:
    """(weight name, modality) of every masked matrix, all of one modality
    ('Uni'): the K, Q, V, attention-output, intermediate and output dense
    of every layer, the pooler and the word embeddings, in that order of
    types."""
    n = cfg["num_hidden_layers"]
    per_type = [f"attention.self.{m}" for m in ("key", "query", "value")] + [
        "attention.output.dense", "intermediate.dense", "output.dense"]
    out = [(f"{PREFIX}.encoder.layer.{i}.{t}.weight", "Uni")
           for t in per_type for i in range(n)]
    out.append((f"{PREFIX}.pooler.dense.weight", "Uni"))
    out.append((f"{PREFIX}.embeddings.word_embeddings.weight", "Uni"))
    return out


def param_table(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in module order (see
    `lxmert.param_table`)."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    emb = f"{PREFIX}.embeddings"
    t = [(f"{emb}.word_embeddings.weight", (cfg["vocab_size"], h), "embed"),
         (f"{emb}.position_embeddings.weight",
          (cfg["max_position_embeddings"], h), "embed"),
         (f"{emb}.token_type_embeddings.weight", (cfg["type_vocab_size"], h),
          "embed"),
         (f"{emb}.visual_projection.weight", (h, cfg["visual_embedding_dim"]),
          "linear"),
         (f"{emb}.visual_projection.bias", (h,), "bias"),
         (f"{emb}.visual_token_type_embeddings.weight",
          (cfg["type_vocab_size"], h), "embed"),
         (f"{emb}.visual_position_embeddings.weight",
          (cfg["max_position_embeddings"], h), "embed"),
         (f"{emb}.LayerNorm.weight", (h,), "ones"),
         (f"{emb}.LayerNorm.bias", (h,), "zeros")]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{PREFIX}.encoder.layer.{i}"
        shapes = {"attention.self.query": (h, h), "attention.self.key": (h, h),
                  "attention.self.value": (h, h),
                  "attention.output.dense": (h, h),
                  "intermediate.dense": (inter, h),
                  "output.dense": (h, inter)}
        for sub, shape in shapes.items():
            t += [(f"{pre}.{sub}.weight", shape, "linear"),
                  (f"{pre}.{sub}.bias", (shape[0],), "bias")]
            if sub in ("attention.output.dense", "output.dense"):
                ln = sub.replace("dense", "LayerNorm")
                t += [(f"{pre}.{ln}.weight", (h,), "ones"),
                      (f"{pre}.{ln}.bias", (h,), "zeros")]
    t += [(f"{PREFIX}.pooler.dense.weight", (h, h), "linear"),
          (f"{PREFIX}.pooler.dense.bias", (h,), "bias")]
    return t + classifier_table(CLASSIFIER, h, cfg["ans_num"])


def forward(p: dict, batch: dict, cfg: dict, draws: Draws,
            prec: Precision = FP32, batch_size: int = None):
    """(logits, pooled) of a block of rows (see `lxmert.forward`)."""
    n = batch_size or batch["input_ids"].shape[0]
    blk = _Blocks(p, cfg, draws, prec, n)
    ids = batch["input_ids"]
    L = ids.shape[1]
    emb = f"{PREFIX}.embeddings"
    text = (F.embedding(ids, p[f"{emb}.word_embeddings.weight"],
                        padding_idx=0)
            + p[f"{emb}.position_embeddings.weight"][:L][None]
            + p[f"{emb}.token_type_embeddings.weight"][0][None, None])
    vis = (linear(batch["visual_embeds"].float(),
                  p[f"{emb}.visual_projection.weight"],
                  p[f"{emb}.visual_projection.bias"], prec)
           + p[f"{emb}.visual_position_embeddings.weight"][0][None, None]
           + p[f"{emb}.visual_token_type_embeddings.weight"][1][None, None])
    h = layer_norm(torch.cat([text, vis], dim=1), p[f"{emb}.LayerNorm.weight"],
                   p[f"{emb}.LayerNorm.bias"], cfg["layer_norm_eps"])
    h = draws.hidden(h, blk.rate_h, n)
    mask = torch.cat([batch["attention_mask"].float(),
                      torch.ones(vis.shape[:2], device=vis.device)], dim=1)
    bias = additive_bias(mask)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{PREFIX}.encoder.layer.{i}"
        h = blk.attend(f"{pre}.attention", "self", h, h, bias)
        h = blk.ffn(f"{pre}.intermediate.dense", f"{pre}.output", h)
    pooled = torch.tanh(blk.dense(f"{PREFIX}.pooler.dense", h[:, 0]))
    x = draws.hidden(pooled, blk.rate_h, n)
    rate_c = cfg["classifier_dropout"] if draws.live else 0.0
    return classify(p, CLASSIFIER, x, rate_c, draws, n, prec), pooled

