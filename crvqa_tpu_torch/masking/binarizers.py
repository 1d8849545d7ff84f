"""Straight-through binarizers for mask training (counterpart of
`crvqa_tpu/masking/binarizers.py`; the reference's three schemes,
`masking/maskers_Robust.py:338-482`).

Each is a `torch.autograd.Function`: the forward binarizes real-valued
scores, the backward passes the gradient straight through to the scores
(none to the threshold).

- scheme 1 (`MaskedLinear1`, every shipped pipeline): scores > threshold,
  identity gradient;
- scheme 2 (`MaskedLinear2`): (sign(scores) + 1) / 2, gradient gated to
  |scores| < 1; the scores are clamped to [-1, 1] after every optimizer
  step (`clamp_scores_sign_`);
- scheme 3 (`MaskedLinear3`): bernoulli(sigmoid(scores)) drawn from an
  explicit generator, identity gradient.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class BinarizeSTE(torch.autograd.Function):
    """scheme 1: 1.0 where scores > threshold (strict), else 0.0."""

    @staticmethod
    def forward(ctx, scores, threshold):
        return (scores > threshold).to(scores.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class BinarizeSign(torch.autograd.Function):
    """scheme 2: (sign(scores) + 1) / 2; gradient where -1 < scores < 1."""

    @staticmethod
    def forward(ctx, scores, threshold):
        ctx.save_for_backward(scores)
        return (torch.sign(scores) + 1.0) / 2.0

    @staticmethod
    def backward(ctx, g):
        (scores,) = ctx.saved_tensors
        gate = (scores < 1.0) & (scores > -1.0)
        return torch.where(gate, g, torch.zeros_like(g)), None


class BinarizeBernoulli(torch.autograd.Function):
    """scheme 3: bernoulli(sigmoid(scores)) from `generator`."""

    @staticmethod
    def forward(ctx, scores, threshold, generator):
        probs = torch.sigmoid(scores)
        return torch.bernoulli(probs, generator=generator).to(scores.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def binarize_ste(scores, threshold):
    return BinarizeSTE.apply(scores, threshold)


def binarize_sign(scores, threshold):
    return BinarizeSign.apply(scores, threshold)


def clamp_scores_sign_(scores: torch.Tensor) -> torch.Tensor:
    """Scheme 2's in-place `clamp_(-1, 1)` (maskers_Robust.py:398-404)."""
    return scores.clamp_(-1.0, 1.0)


def get_binarizer(name: str, generator: Optional[torch.Generator] = None
                  ) -> Callable:
    """The binarizer of a reference masker-class name."""
    if name == "MaskedLinear1":
        return binarize_ste
    if name == "MaskedLinear2":
        return binarize_sign
    if name == "MaskedLinear3":
        if generator is None:
            raise ValueError("MaskedLinear3 (bernoulli) needs a generator")
        return lambda s, t: BinarizeBernoulli.apply(s, t, generator)
    raise NotImplementedError(f"unknown binarizer {name!r}")
