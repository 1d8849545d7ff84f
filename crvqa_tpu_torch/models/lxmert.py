"""LXMERT for VQA (counterpart of `crvqa_tpu/models/lxmert.py`).

Re-design of `hg_transformers/modeling_lxmert.py` (LxmertForMultipleChoice,
LxmertModel, LxmertEncoder, LxmertXLayer) with the reference's module
names: `lxmert.encoder.layer.3.attention.self.query.weight`,
`classifier.main.0.weight_v`, ... Canonical config: hidden 768, 12 heads of
64, language/visual/cross layers 9/5/5, FFN 3072, 2274 answers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from . import layers
from .classifier import SimpleClassifier
from .layers import (CrossAttentionLayer, Dropout, FFNOutput, Intermediate,
                     LayerNorm, PadFrozenEmbed, SelfAttentionLayer, TransformerLayer,
                     extend_attention_mask, init_weights_)


@dataclasses.dataclass(frozen=True)
class LxmertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    l_layers: int = 9
    r_layers: int = 5
    x_layers: int = 5
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    classifier_dropout: float = 0.5
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4
    ans_num: int = 2274  # VQA-CP v2 answer vocabulary
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32
    # A structurally compacted language branch (`masking/compaction.py`;
    # the reference's stage-3 prune_heads / prune_ffns): the 9 language
    # layers' head count and FFN width. None = num_attention_heads /
    # intermediate_size.
    lang_num_heads: Optional[int] = None
    lang_intermediate_size: Optional[int] = None

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "LxmertConfig":
        """2/1/1-layer config for tests (the JAX package's `tiny`)."""
        base = dict(
            vocab_size=128, hidden_size=32, num_attention_heads=4,
            l_layers=2, r_layers=1, x_layers=1, intermediate_size=64,
            max_position_embeddings=32, visual_feat_dim=16, visual_pos_dim=4,
            ans_num=16,
        )
        base.update(kw)
        return cls(**base)

    def layer_kwargs(self) -> dict:
        return dict(num_heads=self.num_attention_heads,
                    head_size=self.head_size, hidden_size=self.hidden_size,
                    attn_dropout=self.attention_probs_dropout_prob,
                    hidden_dropout=self.hidden_dropout_prob, dtype=self.dtype)


class LxmertEmbeddings(nn.Module):
    """word + position + token-type embeddings (fp32) -> compute dtype ->
    LayerNorm -> dropout (`LxmertEmbeddings`)."""

    def __init__(self, c: LxmertConfig):
        super().__init__()
        self.dtype = c.dtype
        self.word_embeddings = PadFrozenEmbed(c.vocab_size, c.hidden_size)
        self.position_embeddings = PadFrozenEmbed(c.max_position_embeddings,
                                                  c.hidden_size)
        self.token_type_embeddings = PadFrozenEmbed(c.type_vocab_size,
                                                    c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos_ids = torch.arange(input_ids.shape[1],
                               device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.LayerNorm(h.to(self.dtype)))


class LxmertVisualFeatureEncoder(nn.Module):
    """(LN(visn_fc(feats)) + LN(box_fc(pos))) / 2 -> dropout."""

    def __init__(self, c: LxmertConfig):
        super().__init__()
        self.dtype = c.dtype
        self.visn_fc = nn.Linear(c.visual_feat_dim, c.hidden_size,
                                 dtype=c.dtype)
        self.visn_layer_norm = LayerNorm(c.hidden_size)
        self.box_fc = nn.Linear(c.visual_pos_dim, c.hidden_size,
                                dtype=c.dtype)
        self.box_layer_norm = LayerNorm(c.hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, visual_feats, visual_pos):
        x = self.visn_layer_norm(self.visn_fc(visual_feats.to(self.dtype)))
        y = self.box_layer_norm(self.box_fc(visual_pos.to(self.dtype)))
        return self.dropout((x + y) / 2)


class LxmertXLayer(nn.Module):
    """Cross-modality layer. ONE `visual_attention` serves both directions
    (language -> vision and vision -> language), sharing its weights as
    the reference does (`modeling_lxmert.py:947-958`): called twice, or
    with `layers.JOINT_CROSS_ATTENTION` once over [lang; visn]."""

    def __init__(self, c: LxmertConfig):
        super().__init__()
        kw = c.layer_kwargs()
        self.visual_attention = CrossAttentionLayer(**kw)
        self.lang_self_att = SelfAttentionLayer(**kw)
        self.visn_self_att = SelfAttentionLayer(**kw)
        self.lang_inter = Intermediate(c.hidden_size, c.intermediate_size,
                                       c.hidden_act, c.dtype)
        self.visn_inter = Intermediate(c.hidden_size, c.intermediate_size,
                                       c.hidden_act, c.dtype)
        self.lang_output = FFNOutput(c.intermediate_size, c.hidden_size,
                                     c.hidden_dropout_prob, c.dtype)
        self.visn_output = FFNOutput(c.intermediate_size, c.hidden_size,
                                     c.hidden_dropout_prob, c.dtype)

    def forward(self, lang, lang_bias, visn, visn_bias):
        if layers.JOINT_CROSS_ATTENTION:
            s = lang.shape[1]
            joint = self.visual_attention(
                torch.cat([lang, visn], dim=1), None, joint_split=s,
                joint_biases=(lang_bias, visn_bias))
            lang_att, visn_att = joint[:, :s], joint[:, s:]
        else:
            lang_att = self.visual_attention(lang, visn, visn_bias)
            visn_att = self.visual_attention(visn, lang, lang_bias)
        lang_att = self.lang_self_att(lang_att, lang_bias)
        visn_att = self.visn_self_att(visn_att, visn_bias)
        lang_out = self.lang_output(self.lang_inter(lang_att), lang_att)
        visn_out = self.visn_output(self.visn_inter(visn_att), visn_att)
        return lang_out, visn_out


class LxmertEncoder(nn.Module):
    """visn_fc -> language layers -> visual layers -> cross layers."""

    def __init__(self, c: LxmertConfig):
        super().__init__()
        kw = dict(c.layer_kwargs(), intermediate_size=c.intermediate_size,
                  act=c.hidden_act)
        lang_kw = dict(kw)
        if c.lang_num_heads is not None:
            lang_kw["num_heads"] = c.lang_num_heads
        if c.lang_intermediate_size is not None:
            lang_kw["intermediate_size"] = c.lang_intermediate_size
        self.visn_fc = LxmertVisualFeatureEncoder(c)
        self.layer = nn.ModuleList(TransformerLayer(**lang_kw)
                                   for _ in range(c.l_layers))
        self.r_layers = nn.ModuleList(TransformerLayer(**kw)
                                      for _ in range(c.r_layers))
        self.x_layers = nn.ModuleList(LxmertXLayer(c)
                                      for _ in range(c.x_layers))

    def forward(self, lang, lang_bias, visual_feats, visual_pos,
                visn_bias=None, collect_hidden=False):
        """`collect_hidden`: also return the language branch's hidden
        states (the embedding output, then after every language and every
        cross layer), the reference encoder's `language_hidden_states`
        (modeling_lxmert.py:1070-1117) that layer-wise KD reads."""
        visn = self.visn_fc(visual_feats, visual_pos)
        hidden = [lang]
        for layer in self.layer:
            lang = layer(lang, lang_bias)
            hidden.append(lang)
        for layer in self.r_layers:
            visn = layer(visn, visn_bias)
        for layer in self.x_layers:
            lang, visn = layer(lang, lang_bias, visn, visn_bias)
            hidden.append(lang)
        return (lang, visn, hidden) if collect_hidden else (lang, visn)


class LxmertPooler(nn.Module):
    """tanh(dense(h[:, 0]))."""

    def __init__(self, c: LxmertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size, dtype=c.dtype)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class LxmertModel(nn.Module):
    """embeddings + encoder + pooler, additive -10000 attention masks.
    `encoder`: the encoder's class (the scan layout's,
    `lxmert_scan.ScanLxmertEncoder`)."""

    def __init__(self, c: LxmertConfig, encoder=LxmertEncoder):
        super().__init__()
        self.embeddings = LxmertEmbeddings(c)
        self.encoder = encoder(c)
        self.pooler = LxmertPooler(c)

    def forward(self, input_ids, visual_feats, visual_pos,
                attention_mask=None, visual_attention_mask=None,
                token_type_ids=None, collect_hidden=False):
        """(lang, visn, pooled), and the hidden-state list last with
        `collect_hidden` (`LxmertEncoder.forward`)."""
        lang_bias = extend_attention_mask(attention_mask)
        visn_bias = extend_attention_mask(visual_attention_mask)
        emb = self.embeddings(input_ids, token_type_ids)
        out = self.encoder(emb, lang_bias, visual_feats, visual_pos,
                           visn_bias, collect_hidden=collect_hidden)
        return out[:2] + (self.pooler(out[0]),) + out[2:]


class LxmertForVQA(nn.Module):
    """LxmertModel + SimpleClassifier(hidden -> 2*hidden -> ans_num) on the
    pooled output. Returns (logits, pooled), both fp32, and with
    `collect_hidden` (logits, pooled, hidden): the language branch's
    hidden states in the compute dtype, for layer-wise KD
    (`Stage2Config.kd_mode`)."""

    def __init__(self, config: LxmertConfig, encoder=LxmertEncoder):
        super().__init__()
        self.config = config
        self.lxmert = LxmertModel(config, encoder)
        self.classifier = SimpleClassifier(config.hidden_size,
                                           2 * config.hidden_size,
                                           config.ans_num,
                                           config.classifier_dropout)

    def forward(self, input_ids, visual_feats, visual_pos,
                attention_mask=None, visual_attention_mask=None,
                token_type_ids=None, collect_hidden=False):
        out = self.lxmert(input_ids, visual_feats, visual_pos,
                          attention_mask, visual_attention_mask,
                          token_type_ids, collect_hidden)
        pooled = out[2]
        logits = self.classifier(pooled)
        return (logits.float(), pooled.float()) + out[3:]


def build_lxmert(config: LxmertConfig, device: torch.device | str = "cpu",
                 generator: Optional[torch.Generator] = None) -> LxmertForVQA:
    """The model on `device` without the default (global-RNG) init: seeded
    from `generator` when given, else left uninitialised for a
    `load_state_dict` that covers every parameter."""
    with torch.device("meta"):
        model = LxmertForVQA(config)
    model.to_empty(device=device)
    if generator is not None:
        init_weights_(model, generator, config.initializer_range)
    return model
