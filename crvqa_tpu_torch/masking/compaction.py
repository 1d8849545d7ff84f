"""Physical head / FFN compaction of a structurally pruned LXMERT
(counterpart of `crvqa_tpu/masking/compaction.py`).

The reference's stage-3 structured path (`run_vqa_stage3.py:307-324`) loads
an [L, H] head-mask `.npy` and an [L, I] FFN-mask `.npy` and calls HF
`prune_heads` / `prune_ffns`, which slice the pruned heads and neurons out
of the language layers. This module rewrites a state_dict once, on the host
side, in the port's names (`lxmert.encoder.layer.<l>.` ...; torch layout
`[out, in]`):

- heads: q/k/v weights `[H*hs, D]` -> `[n_keep*hs, D]` (kept rows) and their
  biases; the attention-output dense weight `[D, H*hs]` -> `[D, n_keep*hs]`
  (its input columns);
- FFN: the intermediate dense weight `[I, D]` -> `[n_keep, D]` and its bias;
  the FFN-output dense weight `[D, I]` -> `[D, n_keep]`.

The model then runs at `LxmertConfig.lang_num_heads` /
`lang_intermediate_size`. Layers keep different counts, but the model has
one shape, so every layer is padded to one kept count with zero slots: a
zero value projection gives a zero context for the padded head, a zero FFN
row gives gelu(0) * 0, so the padding is exact. Head counts round up to a
multiple of 2 (n_keep * 64 a multiple of 128) and FFN widths to a multiple
of 128, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

LANG_PREFIX = "lxmert.encoder.layer."


def _kept_indices(mask_row: np.ndarray, n_keep: int) -> np.ndarray:
    """Indices of kept units, in order; -1 marks zero-padding slots."""
    idx = np.nonzero(np.asarray(mask_row) != 0)[0]
    out = np.full((n_keep,), -1, dtype=np.int64)
    out[: idx.size] = idx
    return out


def _pad_count(counts, multiple: int) -> int:
    n = max(int(max(counts)), 1)
    return int(-(-n // multiple) * multiple)


def _gather_pad(t: torch.Tensor, idx: np.ndarray, dim: int) -> torch.Tensor:
    """Slices `idx` of `t` along `dim`; -1 slots become zeros."""
    index = torch.as_tensor(np.maximum(idx, 0), device=t.device)
    taken = t.index_select(dim, index)
    shape = [1] * t.dim()
    shape[dim] = idx.size
    valid = torch.as_tensor(idx >= 0, device=t.device).reshape(shape)
    return (taken * valid).to(t.dtype)


def compact_lang_heads(state: dict[str, torch.Tensor], head_mask,
                       head_size: int, pad_to_multiple: int = 2,
                       prefix: str = LANG_PREFIX
                       ) -> tuple[dict[str, torch.Tensor], int]:
    """Slice the kept heads out of the language layers' self-attentions.
    `head_mask` is [L, H] (1 = keep). Returns (new state_dict, n_keep), the
    uniform padded head count to use as `LxmertConfig.lang_num_heads`."""
    head_mask = np.asarray(head_mask)
    n_layers, num_heads = head_mask.shape
    n_keep = min(_pad_count(head_mask.sum(axis=1), pad_to_multiple),
                 num_heads)
    out = dict(state)
    for layer in range(n_layers):
        idx = _kept_indices(head_mask[layer], n_keep)
        cols = (np.maximum(idx, 0)[:, None] * head_size
                + np.arange(head_size)[None, :]).reshape(-1)
        cols = np.where(np.repeat(idx, head_size) >= 0, cols, -1)
        att = f"{prefix}{layer}.attention."
        for proj in ("query", "key", "value"):
            for leaf in ("weight", "bias"):
                name = f"{att}self.{proj}.{leaf}"
                out[name] = _gather_pad(state[name], cols, 0)
        name = f"{att}output.dense.weight"
        out[name] = _gather_pad(state[name], cols, 1)
    return out, n_keep


def compact_lang_ffns(state: dict[str, torch.Tensor], ffn_mask,
                      pad_to_multiple: int = 128, prefix: str = LANG_PREFIX
                      ) -> tuple[dict[str, torch.Tensor], int]:
    """Slice the kept FFN neurons out of the language layers. `ffn_mask`
    is [L, I] (1 = keep). Returns (new state_dict, n_keep), the width to use
    as `LxmertConfig.lang_intermediate_size`."""
    ffn_mask = np.asarray(ffn_mask)
    n_layers, inter = ffn_mask.shape
    n_keep = min(_pad_count(ffn_mask.sum(axis=1), pad_to_multiple), inter)
    out = dict(state)
    for layer in range(n_layers):
        idx = _kept_indices(ffn_mask[layer], n_keep)
        base = f"{prefix}{layer}."
        for leaf in ("weight", "bias"):
            name = f"{base}intermediate.dense.{leaf}"
            out[name] = _gather_pad(state[name], idx, 0)
        name = f"{base}output.dense.weight"
        out[name] = _gather_pad(state[name], idx, 1)
    return out, n_keep


def head_mask_from_scores(head_scores, num_to_mask: int) -> np.ndarray:
    """[L, H] scores -> [L, H] 0/1 mask zeroing the globally lowest
    `num_to_mask` heads (`binarizer_fn_head`, prune_debias_VQA.py:642-650)."""
    scores = np.asarray(head_scores)
    flat = scores.reshape(-1)
    order = np.argsort(flat, kind="stable")
    mask = np.ones_like(flat)
    mask[order[:num_to_mask]] = 0.0
    return mask.reshape(scores.shape)



def expand_head_mask_dense(head_mask_row, head_size: int, in_dim: int
                           ) -> np.ndarray:
    """[H] -> the dense mask of a [H*hs, in_dim] weight in the port's
    [out, in] layout: each head's 0/1 repeated over its rows (the JAX
    package's `expand_head_mask_dense` gives its [in, out] transpose; a
    test and audit helper)."""
    rows = np.repeat(np.asarray(head_mask_row), head_size)
    return np.broadcast_to(rows[:, None], (rows.size, in_dim))

def apply_dense_head_mask(state: dict[str, torch.Tensor], head_mask,
                          head_size: int, prefix: str = LANG_PREFIX
                          ) -> dict[str, torch.Tensor]:
    """The dense analogue of `compact_lang_heads`: zero the pruned heads'
    q/k/v weight rows and bias entries in place of removing them (what HF
    `prune_linear_layer` removes)."""
    head_mask = np.asarray(head_mask)
    out = dict(state)
    for layer in range(head_mask.shape[0]):
        for proj in ("query", "key", "value"):
            for leaf in ("weight", "bias"):
                name = f"{prefix}{layer}.attention.self.{proj}.{leaf}"
                out[name] = _scale_rows(state[name], np.repeat(
                    head_mask[layer], head_size))
    return out


def apply_dense_ffn_mask(state: dict[str, torch.Tensor], ffn_mask,
                         prefix: str = LANG_PREFIX) -> dict[str, torch.Tensor]:
    """The dense analogue of `compact_lang_ffns`: zero the pruned neurons'
    intermediate-dense rows and bias entries (gelu(0) * 0 = a removed
    neuron)."""
    ffn_mask = np.asarray(ffn_mask)
    out = dict(state)
    for layer in range(ffn_mask.shape[0]):
        for leaf in ("weight", "bias"):
            name = f"{prefix}{layer}.intermediate.dense.{leaf}"
            out[name] = _scale_rows(state[name], ffn_mask[layer])
    return out


def _scale_rows(t: torch.Tensor, row_mask: np.ndarray) -> torch.Tensor:
    """t with row r (entry r of a bias) multiplied by row_mask[r]."""
    m = torch.as_tensor(np.asarray(row_mask), device=t.device).to(t.dtype)
    return t * (m if t.dim() == 1 else m[:, None])
