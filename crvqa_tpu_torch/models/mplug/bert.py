"""mPLUG's BERT stack: text encoder, stride fusion encoder, causal LM
decoder (counterpart of `crvqa_tpu/models/mplug/bert.py`; the reference's
`mPLUG/models/modeling_mplug.py`).

Names are the reference's: `text_encoder.encoder.layer.{l}`,
`fusion_encoder.encoder.layer.{6..11}` (absolute layer indices),
`text_decoder.bert.{embeddings,encoder.layer.{l}}` and
`text_decoder.cls.predictions.{transform.dense,transform.LayerNorm,bias}`;
the LM head's decoder weight is tied to the word embeddings and has no
parameter of its own. Config `mPLUG/configs/config_bert_stride3.json`.

Dtype policy as in `models/layers.py`: Linear weights in the compute dtype,
embeddings, LayerNorms and the LM-head bias fp32; the LM head's product in
fp32 unless `lm_head_dtype` rounds its operands (fp32 accumulation and fp32
logits either way).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (AttentionOutput, Dropout, FFNOutput,
                      Intermediate, LayerNorm, MultiHeadAttention,
                      PadFrozenEmbed, extend_attention_mask, gelu,
                      maybe_checkpointed)


@dataclasses.dataclass(frozen=True)
class MPlugBertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    text_encoder_layers: int = 6
    fusion_layers: int = 6
    text_decode_layers: int = 12
    stride_layer: int = 3
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32
    # None: the tied LM head in fp32 (reference-exact); torch.bfloat16:
    # operands rounded to bf16, fp32 accumulation and logits
    lm_head_dtype: Optional[torch.dtype] = None
    # activation checkpointing of the text encoder's, the fusion encoder's
    # and (without self caches) the decoder's layers in a training forward
    # (`--use_checkpoint`; the JAX config's use_remat)
    use_checkpoint: bool = False
    # False: the eager attention and output-block epilogues everywhere (the
    # setting under AdaHessian)
    attention_kernels: bool = True

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "MPlugBertConfig":
        base = dict(vocab_size=128, hidden_size=32, num_attention_heads=4,
                    intermediate_size=64, text_encoder_layers=2,
                    fusion_layers=2, text_decode_layers=2, stride_layer=2,
                    max_position_embeddings=64)
        base.update(kw)
        return cls(**base)


class BertEmbeddings(nn.Module):
    """word + position + token-type (all fp32) -> LayerNorm of the sum cast
    to the compute dtype -> dropout."""

    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.dtype = c.dtype
        self.word_embeddings = PadFrozenEmbed(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                position: Optional[int] = None) -> torch.Tensor:
        """`position`: embed the single decode row input_ids [N, 1] at that
        absolute position (the incremental-decode entry)."""
        if position is None:
            pos_ids = torch.arange(input_ids.shape[1],
                                   device=input_ids.device)[None]
        else:
            pos_ids = torch.full((1, 1), position, dtype=torch.long,
                                 device=input_ids.device)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.dropout(self.LayerNorm(h.to(self.dtype)))


class BertSelfBlock(nn.Module):
    """attention (`self`) + output block; `kv` / `self_cache` as in
    `MultiHeadAttention`."""

    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.self = MultiHeadAttention(c.hidden_size, c.num_attention_heads,
                                       c.head_size,
                                       c.attention_probs_dropout_prob,
                                       c.dtype, kernels=c.attention_kernels)
        self.output = AttentionOutput(c.hidden_size, c.hidden_dropout_prob,
                                      c.dtype, kernels=c.attention_kernels)

    def forward(self, x, context, bias, kv=None, self_cache=None,
                cache_position=None):
        if self_cache is not None:
            att, cache = self.self(x, context, bias, self_cache=self_cache,
                                   cache_position=cache_position)
            return self.output(att, x), cache
        return self.output(self.self(x, context, bias, kv=kv), x)


class BertLayer(nn.Module):
    """Self-attention (+ cross-attention) + FFN.

    `memory_groups` g > 1: the N batch rows come in g-sized question-major
    groups sharing one row of `enc_states` (passed unreplicated, batch
    N/g): the cross-attention regroups the queries (N, L) -> (N/g, g*L)
    and attends the shared memory once (bert.py:166-212 of the JAX
    package)."""

    def __init__(self, c: MPlugBertConfig, has_cross: bool = False):
        super().__init__()
        self.attention = BertSelfBlock(c)
        if has_cross:
            self.crossattention = BertSelfBlock(c)
        self.has_cross = has_cross
        self.intermediate = Intermediate(c.hidden_size, c.intermediate_size,
                                         c.hidden_act, c.dtype)
        self.output = FFNOutput(c.intermediate_size, c.hidden_size,
                                c.hidden_dropout_prob, c.dtype,
                                kernels=c.attention_kernels)

    def forward(self, x, self_bias=None, enc_states=None, enc_bias=None,
                cross_kv=None, self_cache=None, cache_position=None,
                memory_groups: int = 1):
        cache = None
        if self_cache is not None:
            x, cache = self.attention(x, x, self_bias, self_cache=self_cache,
                                      cache_position=cache_position)
        else:
            x = self.attention(x, x, self_bias)
        if self.has_cross:
            g = memory_groups
            if g > 1:
                n, length, d = x.shape
                xg = self.crossattention(x.reshape(n // g, g * length, d),
                                         enc_states, enc_bias, kv=cross_kv)
                x = xg.reshape(n, length, d)
            else:
                x = self.crossattention(x, enc_states, enc_bias, kv=cross_kv)
        x = self.output(self.intermediate(x), x)
        return x if cache is None else (x, cache)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = layers


class TextEncoder(nn.Module):
    """`BertModel` with `text_encoder_layers` self-attention layers."""

    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.use_checkpoint = c.use_checkpoint
        self.embeddings = BertEmbeddings(c)
        self.encoder = _Encoder(nn.ModuleList(
            BertLayer(c) for _ in range(c.text_encoder_layers)))

    def forward(self, input_ids, attention_mask=None):
        h = self.embeddings(input_ids)
        bias = extend_attention_mask(attention_mask)
        for layer in self.encoder.layer:
            h = maybe_checkpointed(self.use_checkpoint, layer, h, bias)
        return h


class FusionLayer(nn.Module):
    """stride=False: text self-attention -> text->image cross-attention ->
    FFN. stride=True: one joint self-attention + FFN over [image; text];
    the encoder splits the output and updates the image stream
    residually."""

    def __init__(self, c: MPlugBertConfig, stride: bool):
        super().__init__()
        self.stride = stride
        self.attention = BertSelfBlock(c)
        if not stride:
            self.crossattention = BertSelfBlock(c)
        self.intermediate = Intermediate(c.hidden_size, c.intermediate_size,
                                         c.hidden_act, c.dtype)
        self.output = FFNOutput(c.intermediate_size, c.hidden_size,
                                c.hidden_dropout_prob, c.dtype,
                                kernels=c.attention_kernels)

    def forward(self, text, text_bias, image, image_bias):
        if not self.stride:
            x = self.attention(text, text, text_bias)
            x = self.crossattention(x, image, image_bias)
            return self.output(self.intermediate(x), x), image
        joint = torch.cat([image, text], dim=1)
        joint_bias = None
        if text_bias is not None or image_bias is not None:
            b = text.shape[0]
            ib = image_bias if image_bias is not None else torch.zeros(
                b, 1, 1, image.shape[1], device=text.device)
            tb = text_bias if text_bias is not None else torch.zeros(
                b, 1, 1, text.shape[1], device=text.device)
            joint_bias = torch.cat([ib, tb], dim=3)
        x = self.attention(joint, joint, joint_bias)
        out = self.output(self.intermediate(x), x)
        image_new, text = out[:, :image.shape[1]], out[:, image.shape[1]:]
        return text, image + image_new


class FusionEncoder(nn.Module):
    """`FusionModel`: layers `text_encoder_layers` .. + `fusion_layers` - 1
    of the 12-layer stack; relative layer rel is a stride layer when
    rel != 0 and rel % stride_layer == 0."""

    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.use_checkpoint = c.use_checkpoint
        start = c.text_encoder_layers
        self.encoder = _Encoder(nn.ModuleDict({
            str(start + rel): FusionLayer(
                c, stride=rel != 0 and rel % c.stride_layer == 0)
            for rel in range(c.fusion_layers)}))

    def forward(self, text_embeds, attention_mask, image_embeds,
                image_mask=None):
        text_bias = extend_attention_mask(attention_mask)
        image_bias = extend_attention_mask(image_mask)
        text, image = text_embeds, image_embeds
        for layer in self.encoder.layer.values():
            text, image = maybe_checkpointed(self.use_checkpoint, layer, text,
                                             text_bias, image, image_bias)
        return image, text


def causal_mask_bias(seq_len: int, attention_mask=None,
                     device=None) -> torch.Tensor:
    """Lower-triangular additive bias [1, 1, L, L] (+ the padding mask's
    [B, 1, 1, L]) for the decoder, fp32."""
    if attention_mask is not None:
        device = attention_mask.device
    causal = torch.tril(torch.ones(seq_len, seq_len, device=device))
    bias = ((1.0 - causal) * -10000.0)[None, None]
    if attention_mask is not None:
        bias = bias + extend_attention_mask(attention_mask)
    return bias


class _Transform(nn.Module):
    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size, dtype=c.dtype)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, h):
        return self.LayerNorm(gelu(self.dense(h)))


class _Predictions(nn.Module):
    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.transform = _Transform(c)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size))


class _Cls(nn.Module):
    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.predictions = _Predictions(c)


class _DecoderBert(nn.Module):
    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self.encoder = _Encoder(nn.ModuleList(
            BertLayer(c, has_cross=True)
            for _ in range(c.text_decode_layers)))


class TextDecoder(nn.Module):
    """`BertLMHeadModel`: 12 causal layers with cross-attention to the fused
    states + the LM head (transform, tied decoder, bias)."""

    def __init__(self, c: MPlugBertConfig):
        super().__init__()
        self.config = c
        self.bert = _DecoderBert(c)
        self.cls = _Cls(c)

    def forward(self, input_ids, attention_mask, enc_states, enc_mask,
                cross_kv=None, position: Optional[int] = None,
                memory_groups: int = 1, self_caches=None,
                cache_position: Optional[int] = None):
        """Logits [N, L, V] fp32 (the JAX `TextDecoder.__call__`):

        - `cross_kv`: per-layer precomputed (k, v) of `enc_states`
          (`generator.precompute_cross_kv`);
        - `position`: only that row goes through the LM head -> [N, 1, V];
        - `memory_groups`: see `BertLayer`;
        - `self_caches` / `cache_position`: incremental decode, only the
          `cache_position` row of `input_ids` runs (the prefix comes from
          the per-layer caches, updated in place); returns (logits
          [N, 1, V], caches). `attention_mask` is then ignored."""
        c = self.config
        emb = self.bert.embeddings
        if self_caches is not None:
            tok = input_ids[:, cache_position:cache_position + 1]
            h = emb(tok, position=cache_position)
            max_len = self_caches[0][0].shape[1]
            self_bias = torch.where(
                torch.arange(max_len, device=h.device) <= cache_position,
                0.0, -10000.0).float()[None, None, None, :]
        else:
            h = emb(input_ids)
            self_bias = causal_mask_bias(input_ids.shape[1], attention_mask,
                                         device=input_ids.device)
        enc_bias = extend_attention_mask(enc_mask)
        new_caches = []
        for i, layer in enumerate(self.bert.encoder.layer):
            layer_kv = None if cross_kv is None else cross_kv[i]
            if self_caches is not None:
                h, cache = layer(h, self_bias, enc_states, enc_bias,
                                 cross_kv=layer_kv,
                                 self_cache=self_caches[i],
                                 cache_position=cache_position,
                                 memory_groups=memory_groups)
                new_caches.append(cache)
            else:
                h = maybe_checkpointed(c.use_checkpoint, layer, h, self_bias,
                                       enc_states, enc_bias,
                                       cross_kv=layer_kv,
                                       memory_groups=memory_groups)
        if position is not None and self_caches is None:
            h = h[:, position:position + 1]
        logits = self.lm_head(h)
        return (logits, new_caches) if self_caches is not None else logits

    def lm_head(self, h: torch.Tensor) -> torch.Tensor:
        """transform -> hidden @ word_embeddings^T + bias, fp32 logits."""
        pred = self.cls.predictions
        t = pred.transform(h)
        table = self.bert.embeddings.word_embeddings.weight
        dt = self.config.lm_head_dtype
        if dt is None:
            logits = F.linear(t.float(), table.float())
        else:  # operands rounded to dt, the product accumulated in fp32
            logits = F.linear(t.to(dt).float(), table.to(dt).float())
        return logits + pred.bias


def lm_loss_per_sequence(logits: torch.Tensor, labels: torch.Tensor,
                         pad_id: int = 0) -> torch.Tensor:
    """Per-sequence summed next-token cross-entropy with padding ignored
    (`BertLMHeadModel.forward`, modeling_mplug.py:1904-1916)."""
    shifted = logits[:, :-1].float()
    targets = labels[:, 1:]
    mask = (targets != pad_id).float()
    logp = torch.log_softmax(shifted, dim=-1)
    nll = -torch.gather(logp, -1, targets.clamp_min(0).long()[..., None]
                        )[..., 0]
    return (nll * mask).sum(dim=1)



def soft_label_distill_loss(logits: torch.Tensor, soft_labels: torch.Tensor,
                            labels: torch.Tensor, pad_id: int = 0
                            ) -> torch.Tensor:
    """Per-sequence soft-label distillation term (modeling_mplug.py:
    1915-1916): -sum(log_softmax(shifted logits) * soft_labels) over the
    VOCAB axis, summed over the non-pad target positions. The reference
    takes its log_softmax over the sequence axis; the JAX package computes
    the intended vocab-axis form, and so does the port."""
    shifted = logits[:, :-1].float()
    mask = (labels[:, 1:] != pad_id).float()
    ld = -(torch.log_softmax(shifted, dim=-1) * soft_labels).sum(dim=-1)
    return (ld * mask).sum(dim=1)
