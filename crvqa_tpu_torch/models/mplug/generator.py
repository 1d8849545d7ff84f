"""Autoregressive answer generation for mPLUG (counterpart of
`crvqa_tpu/models/mplug/generator.py`; the reference's
`mPLUG/models/predictor.py:TextGenerator`).

The JAX package's `lax.fori_loop` over a fixed `max_len` is a Python loop
here, with the same static shapes and the same scoring rules. Incremental
decoding keeps per-layer self-attention KV caches [N, max_len, H, D]; after
each step's top-k they are indexed by parent beam. Ties: `top_k` and
`torch.argmax` pick the lowest index, as `lax.top_k` and `jnp.argmax` do.
"""
from __future__ import annotations

from typing import Callable

import torch

from .mplug import top_k

NEG_INF = -1.0e9


def _step_logits(decode_logits, decode_step, ids, states, state_mask, t,
                 max_len, caches):
    """Logits [N, V] of decode position t - 1 (and the updated caches)."""
    if decode_step is not None:
        logits, caches = decode_step(ids, states, state_mask, t - 1, caches)
        return logits[:, 0], caches
    mask = (torch.arange(max_len, device=ids.device)[None, :] < t).float()
    mask = mask.expand(ids.shape[0], max_len)
    return decode_logits(ids, mask, states, state_mask,
                         position=t - 1)[:, 0], caches


def _supports_position(decode_logits: Callable) -> bool:
    """Whether a decode closure takes `position` (the LM head on that one
    row, [N, 1, V]); others return [N, L, V] logits."""
    import inspect

    try:
        return "position" in inspect.signature(decode_logits).parameters
    except (TypeError, ValueError):
        return False


def greedy_generate(decode_logits: Callable, states, state_mask,
                    max_len: int = 12, bos: int = 101, eos: int = 102,
                    pad: int = 0, decode_step: Callable = None,
                    init_caches=None) -> torch.Tensor:
    """Greedy decoding (`greedy_generate` of the JAX package): each step
    appends the argmax token (the lowest index on ties); a row that has
    emitted eos appends `pad` from then on. Returns ids [B, max_len], bos
    first. Three ways to get a step's logits, as in the JAX function:

    - `decode_step(ids, states, state_mask, position, caches) -> (logits
      [N, 1, V], caches)` with `init_caches`: incremental decoding with
      per-layer self-attention KV caches (what a server runs);
    - else a `decode_logits(ids, mask, states, state_mask, position)` that
      takes `position`: [N, 1, V] at that row;
    - else `decode_logits(ids, mask, states, state_mask)`: [N, L, V], the
      step's row taken from it."""
    b = states.shape[0]
    ids = torch.full((b, max_len), pad, dtype=torch.long,
                     device=states.device)
    ids[:, 0] = bos
    done = torch.zeros(b, dtype=torch.bool, device=states.device)
    caches = init_caches
    full = decode_step is None and not _supports_position(decode_logits)
    for t in range(1, max_len):
        if full:
            mask = (torch.arange(max_len, device=ids.device)[None, :]
                    < t).float().expand(b, max_len)
            logits = decode_logits(ids, mask, states, state_mask)[:, t - 1]
        else:
            logits, caches = _step_logits(decode_logits, decode_step, ids,
                                          states, state_mask, t, max_len,
                                          caches)
        tok = torch.argmax(logits, dim=-1)
        tok = torch.where(done, torch.full_like(tok, pad), tok)
        ids[:, t] = tok
        done = done | (tok == eos)
    return ids


def beam_generate(decode_logits: Callable, states, state_mask,
                  beam_size: int = 5, max_len: int = 12, bos: int = 101,
                  eos: int = 102, pad: int = 0, lp_alpha: float = 0.6,
                  min_length: int = 1, group_memory: bool = False,
                  decode_step: Callable = None, init_caches=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """ONMT-style beam search with the reference's scoring
    (predictor.py:197-311; see the JAX function for each rule): GNMT length
    penalty ((5 + step + 1) / 6) ** lp_alpha on the selection scores, EOS
    blocked while step < min_length, finished beams saved with their
    normalised score and kept extending, an item's search ends when its top
    beam finishes (every current beam saved) or at the last step, the best
    normalised hypothesis wins and the earliest one on ties.

    Returns (best_ids [B, max_len] with bos at 0, best_scores [B] fp32).
    `group_memory`: the memory is not replicated per beam; the decode
    closures take B*W query rows over B memory rows (`memory_groups=W`).
    `decode_step(ids, states, state_mask, position, caches) -> (logits
    [B*W, 1, V], caches)` with `init_caches`: incremental decoding."""
    b = states.shape[0]
    w = beam_size
    dev = states.device
    if group_memory:
        rep_states, rep_mask = states, state_mask
    else:
        rep_states = states.repeat_interleave(w, dim=0)
        rep_mask = state_mask.repeat_interleave(w, dim=0)
    ids = torch.full((b, w, max_len), pad, dtype=torch.long, device=dev)
    ids[:, :, 0] = bos
    scores = torch.full((b, w), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    batch_done = torch.zeros(b, dtype=torch.bool, device=dev)
    best_score = torch.full((b,), float("-inf"), device=dev)
    best_ids = torch.full((b, max_len), pad, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    caches = init_caches
    for t in range(1, max_len):
        step = t - 1  # the reference's 0-indexed decode step
        logits, caches = _step_logits(
            decode_logits, decode_step, ids.reshape(b * w, max_len),
            rep_states, rep_mask, t, max_len, caches)
        logp = torch.log_softmax(logits.float(), dim=-1)
        v = logp.shape[-1]
        logp = logp.reshape(b, w, v)
        if step < min_length:  # predictor.py:207-208
            logp[:, :, eos] = -1e20
        cand = (scores[:, :, None] + logp).reshape(b, w * v)
        # the length penalty divides every candidate by one positive
        # constant: top-k over cumulative == top-k over normalised
        top_cum, top_idx = top_k(cand, w)
        penalty = torch.tensor((5.0 + (step + 1.0)) / 6.0,
                               dtype=torch.float32) ** lp_alpha
        top_norm = top_cum / penalty.to(dev)
        beam_idx = top_idx // v
        tok_idx = top_idx % v
        ids = ids[rows, beam_idx]
        ids[:, :, t] = tok_idx
        if caches is not None:
            # reindex the KV caches by parent beam (map_batch_fn,
            # predictor.py:243-253)
            caches = [tuple(c.reshape(b, w, *c.shape[1:])[rows, beam_idx]
                            .reshape(c.shape) for c in layer)
                      for layer in caches]
        is_fin = tok_idx == eos
        if t == max_len - 1:
            is_fin = torch.ones_like(is_fin)
        end_cond = is_fin[:, 0]  # top beam finished -> the item ends
        save = (is_fin | end_cond[:, None]) & ~batch_done[:, None]
        masked = torch.where(save, top_norm, float("-inf"))
        j = torch.argmax(masked, dim=1)  # the lowest index on ties
        step_best = masked[rows[:, 0], j]
        improve = step_best > best_score  # strict: the earlier one wins
        best_score = torch.where(improve, step_best, best_score)
        best_ids = torch.where(improve[:, None], ids[rows[:, 0], j],
                               best_ids)
        batch_done = batch_done | end_cond
        scores = top_cum
    return best_ids, best_score


def init_self_caches(n: int, num_layers: int, max_len: int, num_heads: int,
                     head_size: int, dtype=torch.float32, device=None):
    """Zeroed per-layer self-attention caches [(k, v)], each
    [n, max_len, num_heads, head_size]; rows past the decode position are
    masked by the decoder's cache-validity bias."""
    def z():
        return torch.zeros(n, max_len, num_heads, head_size, dtype=dtype,
                           device=device)

    return [(z(), z()) for _ in range(num_layers)]


def precompute_cross_kv(decoder, states: torch.Tensor, num_layers: int,
                        num_heads: int, head_size: int, dtype=None):
    """Every decoder layer's cross-attention key and value projections of
    the static memory, once: [(k, v)] with k, v [B, S, H, D]. `decoder` is
    the `TextDecoder` (under `functional_call`, holding the masked
    weights)."""
    b, s, _ = states.shape
    x = states if dtype is None else states.to(dtype)
    out = []
    for layer in decoder.bert.encoder.layer[:num_layers]:
        att = layer.crossattention.self

        def proj(lin):
            w, bias = lin.weight, lin.bias
            if dtype is not None:
                w, bias = w.to(dtype), bias.to(dtype)
            return torch.nn.functional.linear(x, w, bias).reshape(
                b, s, num_heads, head_size)

        out.append((proj(att.key), proj(att.value)))
    return out
