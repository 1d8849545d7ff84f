"""Classifier head (counterpart of `crvqa_tpu/models/classifier.py`)."""
from __future__ import annotations

import torch
from torch import nn

from .layers import Dropout, WeightNormDense


class SimpleClassifier(nn.Module):
    """weight-norm Linear -> ReLU -> Dropout -> weight-norm Linear
    (`hg_transformers/classifier.py:SimpleClassifier`). `main` is the
    reference's `nn.Sequential`, so its keys are `main.0.*` / `main.3.*`."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int,
                 dropout: float = 0.5):
        super().__init__()
        self.main = nn.Sequential(WeightNormDense(in_dim, hid_dim), nn.ReLU(),
                                  Dropout(dropout),
                                  WeightNormDense(hid_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)
