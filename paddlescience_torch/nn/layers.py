"""Layers (counterpart of ``paddlescience_tpu/nn/layers.py``): only the
plain ``Linear`` the MLP family needs, in the JAX layout."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from paddlescience_torch.utils import initializer

__all__ = ["Linear"]


class Linear(nn.Module):
    """y = x @ W + b with W of shape (in, out), xavier-uniform initialised
    unless ``kernel_init(tensor, generator)`` is given."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 kernel_init: Optional[Callable] = None, *, generator: torch.Generator):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        init = kernel_init or initializer.xavier_uniform_
        self.weight = nn.Parameter(init(torch.empty(in_features, out_features), generator))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        y = x @ self.weight
        return y + self.bias if self.bias is not None else y
