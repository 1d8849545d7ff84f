"""Plain PyTorch LXMERT for VQA (Tan & Bansal, 2019, arXiv:1908.07490;
the layout of `unc-nlp/lxmert-base-uncased` with the VQA head of the
Compress-Robust-VQA reference, a weight-normalised two-layer classifier).

Parameter names are the published PyTorch names, so one table of weights
feeds this reference and the program alike. The forward computes only
what reaches the logits: the last cross layer's vision branch (its
vision-to-language attention, vision self-attention and vision FFN) feeds
nothing, so it is not computed, and its dropout sites are consumed so
that every later draw lines up with a whole model's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (FP32, Draws, Precision, additive_bias, attention, gelu,
                     layer_norm, linear, weight_norm_linear)

PREFIX = "lxmert"
CLASSIFIER = "classifier"

_SELF = ("self.query", "self.key", "self.value", "output.dense")
_X_WEIGHTS = (
    [f"visual_attention.att.{m}" for m in ("query", "key", "value")]
    + ["visual_attention.output.dense"]
    + [f"lang_self_att.{m}" for m in _SELF]
    + [f"visn_self_att.{m}" for m in _SELF]
    + ["lang_inter.dense", "lang_output.dense", "visn_inter.dense",
       "visn_output.dense"])


def _layer_weights(pre: str) -> list[str]:
    return [f"{pre}.attention.{m}" for m in _SELF] + [
        f"{pre}.intermediate.dense", f"{pre}.output.dense"]


def masked_weights(cfg: dict) -> list[tuple[str, str]]:
    """(weight name, modality) of every masked matrix: the word embeddings,
    both visual projections, every dense of the language (Lang), visual
    (Vis) and cross (Fus) layers, and the pooler (P)."""
    enc = f"{PREFIX}.encoder"
    out = [(f"{PREFIX}.embeddings.word_embeddings.weight", "Lang"),
           (f"{enc}.visn_fc.visn_fc.weight", "Vis"),
           (f"{enc}.visn_fc.box_fc.weight", "Vis")]
    for group, n, mod, names in (
            ("layer", cfg["l_layers"], "Lang", None),
            ("r_layers", cfg["r_layers"], "Vis", None),
            ("x_layers", cfg["x_layers"], "Fus", _X_WEIGHTS)):
        for i in range(n):
            pre = f"{enc}.{group}.{i}"
            subs = (_layer_weights(pre) if names is None
                    else [f"{pre}.{m}" for m in names])
            out += [(f"{s}.weight", mod) for s in subs]
    out.append((f"{PREFIX}.pooler.dense.weight", "P"))
    return out


def param_table(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in module order. init:
    'linear' N(0, 1/fan_in), 'embed' N(0, 0.02), 'ones', 'zeros', 'bias'
    N(0, 0.02), 'wn_v' / 'wn_g' the weight-normalised classifier."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    t: list = []

    def dense(name, n_in, n_out):
        t.extend([(f"{name}.weight", (n_out, n_in), "linear"),
                  (f"{name}.bias", (n_out,), "bias")])

    def norm(name):
        t.extend([(f"{name}.weight", (h,), "ones"),
                  (f"{name}.bias", (h,), "zeros")])

    def attn_block(pre, q_name):
        for m in ("query", "key", "value"):
            dense(f"{pre}.{q_name}.{m}", h, h)
        dense(f"{pre}.output.dense", h, h)
        norm(f"{pre}.output.LayerNorm")

    emb = f"{PREFIX}.embeddings"
    t += [(f"{emb}.word_embeddings.weight", (cfg["vocab_size"], h), "embed"),
          (f"{emb}.position_embeddings.weight",
           (cfg["max_position_embeddings"], h), "embed"),
          (f"{emb}.token_type_embeddings.weight", (cfg["type_vocab_size"], h),
           "embed")]
    norm(f"{emb}.LayerNorm")
    enc = f"{PREFIX}.encoder"
    dense(f"{enc}.visn_fc.visn_fc", cfg["visual_feat_dim"], h)
    norm(f"{enc}.visn_fc.visn_layer_norm")
    dense(f"{enc}.visn_fc.box_fc", cfg["visual_pos_dim"], h)
    norm(f"{enc}.visn_fc.box_layer_norm")
    for group, n in (("layer", cfg["l_layers"]),
                     ("r_layers", cfg["r_layers"])):
        for i in range(n):
            pre = f"{enc}.{group}.{i}"
            attn_block(f"{pre}.attention", "self")
            dense(f"{pre}.intermediate.dense", h, inter)
            dense(f"{pre}.output.dense", inter, h)
            norm(f"{pre}.output.LayerNorm")
    for i in range(cfg["x_layers"]):
        pre = f"{enc}.x_layers.{i}"
        attn_block(f"{pre}.visual_attention", "att")
        attn_block(f"{pre}.lang_self_att", "self")
        attn_block(f"{pre}.visn_self_att", "self")
        dense(f"{pre}.lang_inter.dense", h, inter)
        dense(f"{pre}.visn_inter.dense", h, inter)
        dense(f"{pre}.lang_output.dense", inter, h)
        norm(f"{pre}.lang_output.LayerNorm")
        dense(f"{pre}.visn_output.dense", inter, h)
        norm(f"{pre}.visn_output.LayerNorm")
    dense(f"{PREFIX}.pooler.dense", h, h)
    t += classifier_table(CLASSIFIER, h, cfg["ans_num"])
    return t


def classifier_table(pre: str, h: int, n_ans: int) -> list:
    """SimpleClassifier: weight-normalised h -> 2h, ReLU, dropout, 2h ->
    answers."""
    return [(f"{pre}.main.0.weight_v", (2 * h, h), "wn_v"),
            (f"{pre}.main.0.weight_g", (), "wn_g"),
            (f"{pre}.main.0.bias", (2 * h,), "wn_b"),
            (f"{pre}.main.3.weight_v", (n_ans, 2 * h), "wn_v"),
            (f"{pre}.main.3.weight_g", (), "wn_g"),
            (f"{pre}.main.3.bias", (n_ans,), "wn_b")]


def classify(p: dict, pre: str, pooled, rate: float, draws: Draws,
             batch: int, prec: Precision):
    x = torch.relu(weight_norm_linear(pooled, p[f"{pre}.main.0.weight_v"],
                                      p[f"{pre}.main.0.weight_g"],
                                      p[f"{pre}.main.0.bias"], prec))
    x = draws.hidden(x, rate, batch)
    return weight_norm_linear(x, p[f"{pre}.main.3.weight_v"],
                              p[f"{pre}.main.3.weight_g"],
                              p[f"{pre}.main.3.bias"], prec)


class _Blocks:
    """The attention, output and FFN blocks over one parameter dict."""

    def __init__(self, p, cfg, draws, prec, batch):
        self.p, self.draws, self.prec, self.batch = p, draws, prec, batch
        self.heads = cfg["num_attention_heads"]
        live = draws.live
        self.rate_h = cfg["hidden_dropout_prob"] if live else 0.0
        self.rate_a = cfg["attention_probs_dropout_prob"] if live else 0.0

    def dense(self, name, x):
        return linear(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                      self.prec)

    def out(self, name, x, residual):
        y = self.draws.hidden(self.dense(f"{name}.dense", x), self.rate_h,
                              self.batch)
        return layer_norm(y + residual, self.p[f"{name}.LayerNorm.weight"],
                          self.p[f"{name}.LayerNorm.bias"])

    def attend(self, pre, q_name, x, ctx, key_bias):
        a = attention(self.dense(f"{pre}.{q_name}.query", x),
                      self.dense(f"{pre}.{q_name}.key", ctx),
                      self.dense(f"{pre}.{q_name}.value", ctx), key_bias,
                      self.heads, self.rate_a, self.draws, self.prec)
        return self.out(f"{pre}.output", a, x)

    def ffn(self, inter, out, x):
        return self.out(out, gelu(self.dense(inter, x)), x)

    def dead(self, shape, attention_site: bool, device) -> None:
        """Consume the dropout sites of a block whose output reaches no
        loss: its attention's seed and its output's mask."""
        if attention_site and self.rate_a:
            self.draws.dead_attn()
        self.draws.dead_hidden(shape, self.rate_h, device)


def forward(p: dict, batch: dict, cfg: dict, draws: Draws,
            prec: Precision = FP32, batch_size: int = None):
    """(logits, pooled) of a block of rows. `batch_size`: the whole
    batch's rows, the shape each dropout site draws for."""
    n = batch_size or batch["input_ids"].shape[0]
    blk = _Blocks(p, cfg, draws, prec, n)
    ids = batch["input_ids"]
    b, L = ids.shape
    dev = ids.device
    emb = f"{PREFIX}.embeddings"
    h = (F.embedding(ids, p[f"{emb}.word_embeddings.weight"], padding_idx=0)
         + p[f"{emb}.position_embeddings.weight"][:L][None]
         + p[f"{emb}.token_type_embeddings.weight"][0][None, None])
    lang = draws.hidden(layer_norm(h, p[f"{emb}.LayerNorm.weight"],
                                   p[f"{emb}.LayerNorm.bias"]),
                        blk.rate_h, n)
    enc = f"{PREFIX}.encoder"
    vf = f"{enc}.visn_fc"
    x = layer_norm(blk.dense(f"{vf}.visn_fc", batch["visual_feats"].float()),
                   p[f"{vf}.visn_layer_norm.weight"],
                   p[f"{vf}.visn_layer_norm.bias"])
    y = layer_norm(blk.dense(f"{vf}.box_fc", batch["visual_pos"].float()),
                   p[f"{vf}.box_layer_norm.weight"],
                   p[f"{vf}.box_layer_norm.bias"])
    visn = draws.hidden((x + y) / 2, blk.rate_h, n)
    lang_bias = additive_bias(batch["attention_mask"])
    for i in range(cfg["l_layers"]):
        pre = f"{enc}.layer.{i}"
        lang = blk.attend(f"{pre}.attention", "self", lang, lang, lang_bias)
        lang = blk.ffn(f"{pre}.intermediate.dense", f"{pre}.output", lang)
    for i in range(cfg["r_layers"]):
        pre = f"{enc}.r_layers.{i}"
        visn = blk.attend(f"{pre}.attention", "self", visn, visn, None)
        visn = blk.ffn(f"{pre}.intermediate.dense", f"{pre}.output", visn)
    hidden = cfg["hidden_size"]
    vshape = (n, visn.shape[1], hidden)
    for i in range(cfg["x_layers"]):
        pre = f"{enc}.x_layers.{i}"
        last = i == cfg["x_layers"] - 1
        lang_att = blk.attend(f"{pre}.visual_attention", "att", lang, visn,
                              None)
        if last:
            blk.dead(vshape, True, dev)
        else:
            visn_att = blk.attend(f"{pre}.visual_attention", "att", visn,
                                  lang, lang_bias)
        lang_att = blk.attend(f"{pre}.lang_self_att", "self", lang_att,
                              lang_att, lang_bias)
        if last:
            blk.dead(vshape, True, dev)
        else:
            visn_att = blk.attend(f"{pre}.visn_self_att", "self", visn_att,
                                  visn_att, None)
        lang = blk.ffn(f"{pre}.lang_inter.dense", f"{pre}.lang_output",
                       lang_att)
        if last:
            blk.dead(vshape, False, dev)
        else:
            visn = blk.ffn(f"{pre}.visn_inter.dense", f"{pre}.visn_output",
                           visn_att)
    pooled = torch.tanh(blk.dense(f"{PREFIX}.pooler.dense", lang[:, 0]))
    rate_c = cfg["classifier_dropout"] if draws.live else 0.0
    logits = classify(p, CLASSIFIER, pooled, rate_c, draws, n, prec)
    return logits, pooled
