"""Exact k-th smallest value (counterpart of `crvqa_tpu/ops/kthvalue.py`).

Binarization thresholds are the exact k-th smallest score of each weight
matrix (`mask_trainer_Robust_VQA.py:467-482`); `torch.kthvalue` returns
that element on the CPU and on the card. Callers binarize with a strict
`>`, so ties at the threshold are zeroed. A stacked weight ([L, ...], the
scan layout) takes one k-th value per layer in one call
(`kth_smallest_rows`), each the same element the layer's own matrix
gives.
"""
from __future__ import annotations

import torch


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest (1-indexed, clamped to [1, numel]) of the flattened
    tensor, as a 0-d tensor on x's device."""
    flat = x.reshape(-1)
    k = min(max(int(k), 1), flat.numel())
    return torch.kthvalue(flat, k).values


def kth_smallest_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest (1-indexed, clamped to [1, n]) of each x[i] over its
    n = numel / L entries, as an [L] tensor: `kth_smallest` of every
    layer of a stacked [L, ...] tensor (`_per_layer_kth`,
    crvqa_tpu/masking/masker.py:55-63)."""
    rows = x.reshape(x.shape[0], -1)
    k = min(max(int(k), 1), rows.shape[1])
    return torch.kthvalue(rows, k, dim=1).values


def sparsity_threshold(scores: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Threshold t such that `scores > t` has about `sparsity` zero rate:
    k = max(int(n * sparsity), 1), as the reference
    (`mask_trainer_Robust_VQA.py:475-478`)."""
    return kth_smallest(scores, max(int(scores.numel() * sparsity), 1))
