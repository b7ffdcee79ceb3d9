"""Layers (counterpart of ``paddlescience_tpu/nn/layers.py``): ``Linear``
in the JAX layout (W of shape (in, out)), ``Conv`` over channel-first
inputs with JAX's padding rules, ``LayerNorm`` with JAX's parameter
names (``scale``, ``shift``) and its ``epsilon``, and ``Embedding`` (a
(num, features) ``weight`` table on both sides).

``Conv`` keeps its kernel in torch's layout (out, in / groups, *window);
the JAX kernel is (*window, in / groups, out), and ``utils/jax_params.py``
transposes it on the way in (``jax_layout``). ``padding="SAME"`` pads
each spatial axis by ``max((ceil(n / s) - 1) s + (k - 1) d + 1 - n, 0)``
in total, ``total // 2`` before and the rest after, as XLA does: with an
even kernel or a stride the extra row goes at the end, which torch's
``padding="same"`` (refused for strides above 1) does not express.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.utils import initializer

__all__ = ["Linear", "Conv", "LayerNorm", "Embedding", "same_padding"]


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


def same_padding(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int],
                 dilation: Sequence[int]) -> list:
    """XLA's ``"SAME"`` padding per spatial axis as (low, high) pairs."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class Conv(nn.Module):
    """N-D convolution (1 to 3 spatial axes) of channel-first inputs (B,
    C_in, *spatial) -> (B, C_out, *spatial'). ``padding``: "SAME",
    "VALID", an int, or a (low, high) pair per axis; ``padding_mode``
    "zeros", "circular" or "replicate" (the latter two pad with ``F.pad``
    before a VALID convolution, as the JAX layer pads with ``jnp.pad``).
    Initialised uniform in +-1/sqrt(fan_in) from ``generator``."""

    jax_layout = {"weight": "conv"}  # the JAX kernel is (*window, in, out)

    def __init__(self, in_features: int, out_features: int, kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1, padding: Union[str, int, Sequence] = "SAME",
                 dilation: Union[int, Sequence[int]] = 1, groups: int = 1, bias: bool = True,
                 padding_mode: str = "zeros", *, generator: torch.Generator):
        super().__init__()
        kernel_size = (kernel_size,) if isinstance(kernel_size, int) else tuple(kernel_size)
        self.ndim = len(kernel_size)
        self.kernel_size = kernel_size
        self.strides = (strides,) * self.ndim if isinstance(strides, int) else tuple(strides)
        self.dilation = (dilation,) * self.ndim if isinstance(dilation, int) else tuple(dilation)
        if isinstance(padding, int):
            padding = [(padding, padding)] * self.ndim
        if padding_mode in ("circular", "replicate") and padding == "SAME":
            padding = [((k - 1) // 2, k // 2) for k in kernel_size]
        self.padding = padding
        self.padding_mode = padding_mode
        self.groups = groups
        fan_in = (in_features // groups) * math.prod(kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty((out_features, in_features // groups) + kernel_size).uniform_(-bound, bound,
                                                                                     generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self._conv = (F.conv1d, F.conv2d, F.conv3d)[self.ndim - 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            pads = same_padding(x.shape[2:], self.kernel_size, self.strides, self.dilation)
        elif self.padding == "VALID":
            pads = [(0, 0)] * self.ndim
        else:
            pads = [tuple(p) for p in self.padding]
        flat = [v for pair in reversed(pads) for v in pair]  # F.pad lists the last axis first
        if any(flat):
            mode = {"zeros": "constant", "circular": "circular", "replicate": "replicate"}[self.padding_mode]
            x = F.pad(x, flat, mode=mode)
        return self._conv(x, self._kernel(), self.bias, stride=self.strides, dilation=self.dilation,
                          groups=self.groups)

    def _kernel(self) -> torch.Tensor:
        """The effective kernel: the override point of a reparameterised
        weight (PhyCRNet's weight norm), as in the JAX layer."""
        return self.weight


class LayerNorm(nn.Module):
    """Normalisation over the last axis: (x - mean) / sqrt(var + epsilon)
    (the biased variance), then ``scale`` and ``shift``."""

    def __init__(self, num_features: int, epsilon: float = 1e-5, elementwise_affine: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.num_features = num_features
        self.scale = nn.Parameter(torch.ones(num_features)) if elementwise_affine else None
        self.shift = nn.Parameter(torch.zeros(num_features)) if elementwise_affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (self.num_features,), self.scale, self.shift, self.epsilon)


class Embedding(nn.Module):
    """Rows of a (num_embeddings, features) ``weight`` table, N(0, 1)
    initialised from ``generator``: ``idx`` (integers of any shape) ->
    idx.shape + (features,) (``jnp.take`` along axis 0)."""

    def __init__(self, num_embeddings: int, features: int, *, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features).normal_(generator=generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight)
