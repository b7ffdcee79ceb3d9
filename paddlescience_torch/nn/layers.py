"""Layers (counterpart of ``paddlescience_tpu/nn/layers.py``): only the
plain ``Linear`` the MLP family needs, in the JAX layout."""

from __future__ import annotations

import torch
from torch import nn

from paddlescience_torch.utils import initializer

__all__ = ["Linear"]


class Linear(nn.Module):
    """y = x @ W + b with W of shape (in, out), xavier-uniform initialised."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(initializer.xavier_uniform_(torch.empty(in_features, out_features), generator))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        y = x @ self.weight
        return y + self.bias if self.bias is not None else y
