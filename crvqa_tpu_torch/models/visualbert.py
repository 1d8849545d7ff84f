"""VisualBERT for VQA (counterpart of `crvqa_tpu/models/visualbert.py`): the
single-stream, uniform-sparsity model family.

Re-design of `hg_transformers/modeling_visualbert.py` with the reference's
module names (`visual_bert.embeddings.word_embeddings.weight`,
`visual_bert.encoder.layer.0.attention.self.query.weight`,
`cls.main.0.weight_v`, ...): text embeddings (word + position + token type)
concatenated with the projected visual features (+ visual token type 1 and
a constant visual position 0), one LayerNorm over the joint sequence, one
BERT stack over it, a first-token pooler and SimpleClassifier under `cls`.
The stage-2 trainer calls it with (input_ids, visual_embeds) only
(`mask_trainer_visualBERT_VQA.py:820`). At 14 text tokens and 36 boxes the
stream is 50 long, so at 12 heads every layer's attention is the short
kernel's (H * S = 600 <= 1024).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .classifier import SimpleClassifier
from .layers import (Dropout, LayerNorm, PadFrozenEmbed, TransformerLayer,
                     extend_attention_mask, init_weights_)


@dataclasses.dataclass(frozen=True)
class VisualBertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # SimpleClassifier's dropout (the reference hardcodes 0.5,
    # modeling_visualbert.py:1028-1029)
    classifier_dropout: float = 0.5
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    visual_embedding_dim: int = 2048
    ans_num: int = 2274
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32
    # A structurally compacted stack (`masking/compaction.py`): every
    # layer's head count and FFN width. None = dense.
    compact_num_heads: Optional[int] = None
    compact_intermediate_size: Optional[int] = None

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "VisualBertConfig":
        """2-layer config for tests (the JAX package's `tiny`)."""
        base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=32, visual_embedding_dim=16,
                    ans_num=16)
        base.update(kw)
        return cls(**base)


class VisualBertEmbeddings(nn.Module):
    """Text + visual embedding fusion (modeling_visualbert.py:77-205). The
    word table has the reference's padding_idx=0 (no gradient to its pad
    row); the visual projection computes in fp32 whatever the compute
    dtype, and the joint sequence is cast to the compute dtype only before
    the shared LayerNorm."""

    def __init__(self, c: VisualBertConfig):
        super().__init__()
        self.dtype = c.dtype
        self.word_embeddings = PadFrozenEmbed(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.visual_projection = nn.Linear(c.visual_embedding_dim,
                                           c.hidden_size, dtype=torch.float32)
        self.visual_token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                         c.hidden_size)
        self.visual_position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, visual_embeds, token_type_ids=None,
                visual_token_type_ids=None):
        dev = input_ids.device
        pos_ids = torch.arange(input_ids.shape[1], device=dev)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        text = (self.word_embeddings(input_ids)
                + self.position_embeddings(pos_ids)
                + self.token_type_embeddings(token_type_ids))
        vis = self.visual_projection(visual_embeds.float())
        if visual_token_type_ids is None:
            visual_token_type_ids = torch.ones(vis.shape[:-1],
                                               dtype=torch.long, device=dev)
        vpos_ids = torch.zeros(vis.shape[:-1], dtype=torch.long, device=dev)
        visual = (vis + self.visual_position_embeddings(vpos_ids)
                  + self.visual_token_type_embeddings(visual_token_type_ids))
        joint = torch.cat([text, visual], dim=1).to(self.dtype)
        return self.dropout(self.LayerNorm(joint))


class VisualBertEncoder(nn.Module):
    """The BERT stack over the joint sequence (`encoder.layer.N`)."""

    def __init__(self, c: VisualBertConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(
            num_heads=c.compact_num_heads or c.num_attention_heads,
            head_size=c.head_size, hidden_size=c.hidden_size,
            intermediate_size=(c.compact_intermediate_size
                               or c.intermediate_size),
            act=c.hidden_act, attn_dropout=c.attention_probs_dropout_prob,
            hidden_dropout=c.hidden_dropout_prob, dtype=c.dtype)
            for _ in range(c.num_hidden_layers))

    def forward(self, h, bias=None, collect_hidden=False):
        """`collect_hidden`: (h, hidden), hidden the embedding output and
        the output of every layer, for layer-wise KD."""
        hidden = [h]
        for layer in self.layer:
            h = layer(h, bias)
            hidden.append(h)
        return (h, hidden) if collect_hidden else h


class VisualBertPooler(nn.Module):
    """tanh(dense(h[:, 0]))."""

    def __init__(self, c: VisualBertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size, dtype=c.dtype)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class VisualBertModel(nn.Module):
    """embeddings + encoder + first-token pooler (modeling_visualbert.py:
    687-877); the text mask and the visual mask (ones when only the text
    mask is given) form one additive -10000 key bias."""

    def __init__(self, c: VisualBertConfig):
        super().__init__()
        self.embeddings = VisualBertEmbeddings(c)
        self.encoder = VisualBertEncoder(c)
        self.pooler = VisualBertPooler(c)

    def forward(self, input_ids, visual_embeds, attention_mask=None,
                visual_attention_mask=None, token_type_ids=None,
                collect_hidden=False):
        """(h, pooled), and the hidden-state list last with
        `collect_hidden` (`VisualBertEncoder.forward`)."""
        h = self.embeddings(input_ids, visual_embeds, token_type_ids)
        bias = None
        if attention_mask is not None:
            if visual_attention_mask is None:
                visual_attention_mask = torch.ones(
                    visual_embeds.shape[:-1], dtype=attention_mask.dtype,
                    device=attention_mask.device)
            bias = extend_attention_mask(torch.cat(
                [attention_mask, visual_attention_mask], dim=1))
        out = self.encoder(h, bias, collect_hidden)
        if collect_hidden:
            h, hidden = out
            return h, self.pooler(h), hidden
        return out, self.pooler(out)


class VisualBertForVQA(nn.Module):
    """`VisualBertForMultipleChoice` (modeling_visualbert.py:1021-1184):
    VisualBertModel, a hidden dropout on the pooled vector (:1146-1147),
    then SimpleClassifier(hidden -> 2*hidden -> ans_num) named `cls` (the
    stage-2 trainer saves `model.cls` as the classifier artifact). Returns
    (logits, pooled), both fp32, and with `collect_hidden` (logits,
    pooled, hidden) for layer-wise KD."""

    def __init__(self, config: VisualBertConfig):
        super().__init__()
        self.config = config
        self.visual_bert = VisualBertModel(config)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.cls = SimpleClassifier(config.hidden_size,
                                    2 * config.hidden_size, config.ans_num,
                                    config.classifier_dropout)

    def forward(self, input_ids, visual_embeds, attention_mask=None,
                visual_attention_mask=None, token_type_ids=None,
                collect_hidden=False):
        out = self.visual_bert(input_ids, visual_embeds, attention_mask,
                               visual_attention_mask, token_type_ids,
                               collect_hidden)
        pooled = out[1]
        logits = self.cls(self.dropout(pooled))
        return (logits.float(), pooled.float()) + tuple(out[2:])


def build_visualbert(config: VisualBertConfig,
                     device: torch.device | str = "cpu",
                     generator: Optional[torch.Generator] = None
                     ) -> VisualBertForVQA:
    """The model on `device` without the default (global-RNG) init: seeded
    from `generator` when given, else left uninitialised for a
    `load_state_dict` that covers every parameter."""
    with torch.device("meta"):
        model = VisualBertForVQA(config)
    model.to_empty(device=device)
    if generator is not None:
        init_weights_(model, generator, config.initializer_range)
    return model
