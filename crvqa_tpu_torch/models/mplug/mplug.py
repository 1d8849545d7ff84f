"""The composite mPLUG VQA model: CLIP ViT + text encoder + fusion encoder +
LM decoder (counterpart of `crvqa_tpu/models/mplug/mplug.py`; the
reference's `mPLUG/models/model_vqa_mplug.py:MPLUG`).

Serving entries: `encode`, `decode_logits`, `decode_logits_step` and answer
ranking (`rank_answers`, `rank_answers_topk`, `rank_answers_from_states`).
Training entries: `loss` (the JAX module's `__call__`), `answer_logits` (the
momentum twins' soft labels) and `momentum_update`. The twins are a second
parameter dict run through the same module, not `_m` submodules.

Spans (`utils/profiling.span`, recorded only under `tracing(True)`):
`visual_encoder` (the ViT and the `visn_*` adapter), `text_fusion` (the
text and fusion encoders) and `decoder` (the decoder, the LM head and,
in `loss`, the loss), children of the training step's `forward`.

`forward(fn, *args)` runs `fn(self, *args)`: the hook through which
`torch.func.functional_call` runs any method, or a whole generation loop,
on a parameter dict (the masked weights) in one reparametrisation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ...utils.profiling import span
from ..layers import Dropout, LayerNorm
from .bert import (FusionEncoder, MPlugBertConfig, TextDecoder, TextEncoder,
                   lm_loss_per_sequence, soft_label_distill_loss)
from .vit import ViTConfig, VisualEncoder


@dataclasses.dataclass(frozen=True)
class MPlugConfig:
    bert: MPlugBertConfig = MPlugBertConfig()
    vit: ViTConfig = ViTConfig()
    pad_token_id: int = 0
    eos_token_id: int = 102  # '[SEP]'
    bos_token_id: int = 101  # '[CLS]'
    distill: bool = False
    momentum: float = 0.995

    @classmethod
    def tiny(cls, **kw) -> "MPlugConfig":
        return cls(bert=MPlugBertConfig.tiny(), vit=ViTConfig.tiny(), **kw)

    @classmethod
    def vit_l(cls, image_res: int = 392,
              bert: Optional[MPlugBertConfig] = None, **kw) -> "MPlugConfig":
        """`clip_name: ViT-L-14`: the 1024-wide tower plus the visn_fc /
        visn_layer_norm adapter (model_vqa_mplug.py:143-147)."""
        return cls(bert=bert if bert is not None else MPlugBertConfig(),
                   vit=ViTConfig.vit_l_14(image_res=image_res), **kw)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, largest
    first, the lowest index first among equal values (`lax.top_k`'s order,
    which `torch.topk` does not promise)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class MPlug(nn.Module):
    """Module tree with the reference names: visual_encoder / text_encoder
    / fusion_encoder / text_decoder (+ visn_fc / visn_layer_norm when the
    ViT is wider than the BERT stack)."""

    def __init__(self, config: MPlugConfig):
        super().__init__()
        c = config
        self.config = c
        self.visual_encoder = VisualEncoder(c.vit)
        self.text_encoder = TextEncoder(c.bert)
        self.fusion_encoder = FusionEncoder(c.bert)
        self.text_decoder = TextDecoder(c.bert)
        if c.vit.width != c.bert.hidden_size:
            self.visn_fc = nn.Linear(c.vit.width, c.bert.hidden_size,
                                     dtype=c.bert.dtype)
            self.visn_layer_norm = LayerNorm(c.bert.hidden_size)
            self.visn_dropout = Dropout(c.bert.hidden_dropout_prob)

    def forward(self, fn: Callable, *args, **kwargs):
        return fn(self, *args, **kwargs)

    def encode(self, images, question_ids, question_mask):
        """image + question -> (fused decoder memory [B, 1 + P + Lq,
        hidden], its mask) (`MPLUG.forward` eval path,
        model_vqa_mplug.py:119-130)."""
        with span("visual_encoder"):
            image_embeds = self.visual_encoder(images)
            if hasattr(self, "visn_fc"):
                image_embeds = self.visn_dropout(
                    self.visn_layer_norm(self.visn_fc(image_embeds)))
            image_mask = torch.ones(image_embeds.shape[:-1],
                                    dtype=torch.float32,
                                    device=image_embeds.device)
        with span("text_fusion"):
            text_embeds = self.text_encoder(question_ids, question_mask)
            image_out, question_out = self.fusion_encoder(
                text_embeds, question_mask, image_embeds, image_mask)
            states = torch.cat([image_out, question_out], dim=1)
            state_mask = torch.cat([image_mask, question_mask.float()],
                                   dim=1)
        return states, state_mask

    def _answer_logits(self, states, state_mask, answer_ids, answer_mask):
        b, a, length = answer_ids.shape
        return self.text_decoder(answer_ids.reshape(b * a, length),
                                 answer_mask.reshape(b * a, length),
                                 states, state_mask, memory_groups=a)

    def answer_logits(self, images, question_ids, question_mask, answer_ids,
                      answer_mask) -> torch.Tensor:
        """Flat per-answer-slot decoder logits [B*A, L, V]. The A answer
        rows of a question share its fused states: the decoder attends the
        UNREPLICATED memory (`memory_groups=A`), so its cross-attention is
        (A*L, 1 + P + Lq) per question."""
        states, state_mask = self.encode(images, question_ids, question_mask)
        with span("decoder"):
            return self._answer_logits(states, state_mask, answer_ids,
                                       answer_mask)

    def loss(self, images, question_ids, question_mask, answer_ids,
             answer_mask, weights, bias=None, soft_labels=None,
             alpha=0.0) -> torch.Tensor:
        """The training loss (the JAX module's `__call__`;
        model_vqa_mplug.py:112-116): answer_ids / answer_mask [B, A, L], A
        answer slots per question; weights [B, A], 0 for padded slots.
        Returns sum(weights * (1 - bias) * per-answer LM loss) / B.
        `soft_labels` [B*A, L-1, V] (the momentum twin's softmax) mixes a
        distillation term at weight `alpha`: (1 - alpha) * CE + alpha *
        distill (modeling_mplug.py:1915-1917)."""
        c = self.config
        b, a, length = answer_ids.shape
        states, state_mask = self.encode(images, question_ids, question_mask)
        with span("decoder"):
            logits = self._answer_logits(states, state_mask, answer_ids,
                                         answer_mask)
            flat_ids = answer_ids.reshape(b * a, length)
            per_answer = lm_loss_per_sequence(logits, flat_ids,
                                              c.pad_token_id)
            if soft_labels is not None:
                distill = soft_label_distill_loss(logits, soft_labels,
                                                  flat_ids, c.pad_token_id)
                per_answer = (1.0 - alpha) * per_answer + alpha * distill
            loss = weights.reshape(b * a) * per_answer
            if bias is not None:
                loss = (1.0 - bias.reshape(b * a)) * loss
            return loss.sum() / b

    def decode_logits(self, answer_ids, answer_mask, states, state_mask,
                      cross_kv=None, position=None, memory_groups: int = 1):
        """Decoder logits for generation and ranking (see
        `TextDecoder.forward`)."""
        return self.text_decoder(answer_ids, answer_mask, states, state_mask,
                                 cross_kv=cross_kv, position=position,
                                 memory_groups=memory_groups)

    def decode_logits_step(self, answer_ids, states, state_mask,
                           cache_position: int, self_caches, cross_kv=None,
                           memory_groups: int = 1):
        """One incremental decode step -> (logits [N, 1, V], caches)."""
        return self.text_decoder(answer_ids, None, states, state_mask,
                                 cross_kv=cross_kv,
                                 memory_groups=memory_groups,
                                 self_caches=self_caches,
                                 cache_position=cache_position)

    def rank_answers(self, images, question_ids, question_mask,
                     answer_list_ids, answer_list_mask) -> torch.Tensor:
        """Every candidate's summed LM loss against the fused states: [B, K]
        (lower is better)."""
        states, state_mask = self.encode(images, question_ids, question_mask)
        b = states.shape[0]
        k = answer_list_ids.shape[0]
        tiled_ids = answer_list_ids.repeat(b, 1)
        tiled_mask = answer_list_mask.repeat(b, 1)
        logits = self.text_decoder(tiled_ids, tiled_mask, states, state_mask,
                                   memory_groups=k)
        losses = lm_loss_per_sequence(logits, tiled_ids,
                                      self.config.pad_token_id)
        return losses.reshape(b, k)

    def rank_answers_topk(self, images, question_ids, question_mask,
                          answer_list_ids, answer_list_mask, k: int = 10):
        """First-token top-k shortlist + chain-rule re-rank (`rank_answer`,
        model_vqa_mplug.py:188-245). Returns (ids [B, k] into the answer
        list, best first; their re-ranked probabilities [B, k])."""
        states, state_mask = self.encode(images, question_ids, question_mask)
        return self.rank_answers_from_states(
            states, state_mask, answer_list_ids, answer_list_mask, k)

    def rank_answers_from_states(self, states, state_mask, answer_list_ids,
                                 answer_list_mask, k: int = 10):
        """The post-encoder half of `rank_answers_topk`."""
        b = states.shape[0]
        # 1. bos-only pass: p(first token | states)
        start_ids = answer_list_ids[0, 0].expand(b, 1)
        start_mask = torch.ones(b, 1, device=states.device)
        start_logits = self.text_decoder(start_ids, start_mask, states,
                                         state_mask)
        first_tokens = answer_list_ids[:, 1]
        prob_first = torch.softmax(start_logits[:, 0, :].float(),
                                   dim=-1)[:, first_tokens]
        topk_probs, topk_ids = top_k(prob_first, k)
        # 2. full decoder pass over the shortlist (question-major groups)
        short_ids = answer_list_ids[topk_ids.reshape(-1)]
        short_mask = answer_list_mask[topk_ids.reshape(-1)]
        logits = self.text_decoder(short_ids, short_mask, states, state_mask,
                                   memory_groups=k)
        losses = lm_loss_per_sequence(logits, short_ids,
                                      self.config.pad_token_id)
        # 3. chain-rule re-rank: log p(first) - full loss, softmaxed over k
        log_probs_sum = torch.log(topk_probs.reshape(-1)) - losses
        rerank = torch.softmax(log_probs_sum.reshape(b, k), dim=-1)
        rerank_probs, rerank_id = top_k(rerank, k)
        return torch.gather(topk_ids, 1, rerank_id), rerank_probs


@torch.no_grad()
def momentum_update_(params_m: dict[str, torch.Tensor],
                     params: dict[str, torch.Tensor],
                     momentum: float = 0.995) -> None:
    """EMA update of the distillation twins, in place (`_momentum_update`,
    model_vqa_mplug.py:150-181): m <- m * momentum + p * (1 - momentum) for
    every leaf (the JAX package's `momentum_update` returns a new tree)."""
    keys = [k for k in params_m if params_m[k].dtype.is_floating_point]
    ms = [params_m[k] for k in keys]
    torch._foreach_mul_(ms, momentum)
    torch._foreach_add_(ms, [params[k].to(params_m[k].dtype) for k in keys],
                        alpha=1.0 - momentum)
