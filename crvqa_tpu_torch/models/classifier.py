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


_ACTS = {"ReLU": nn.ReLU, "Sigmoid": nn.Sigmoid, "Tanh": nn.Tanh}


class FCNet(nn.Module):
    """`fc.py:FCNet`: per pair of `dims`, weight-norm Linear -> activation
    -> Dropout. `main` holds them as the JAX module names them
    (`main_{3i}`), so the i-th Linear's keys are `main.{3i}.*`."""

    def __init__(self, dims: tuple[int, ...], dropout: float = 0.0,
                 act: str = "ReLU"):
        super().__init__()
        layers: list[nn.Module] = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layers += [WeightNormDense(d_in, d_out), _ACTS[act](),
                       Dropout(dropout)]
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


class GTH(nn.Module):
    """`fc.py:GTH`, the gated tanh unit: tanh(FCNet(x)) * sigmoid(FCNet(x))
    over two FCNets named `nonlinear` and `gate`."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.0):
        super().__init__()
        self.nonlinear = FCNet((in_dim, out_dim), dropout, "Tanh")
        self.gate = FCNet((in_dim, out_dim), dropout, "Sigmoid")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlinear(x) * self.gate(x)
