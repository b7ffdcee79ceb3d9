"""Recurrent layers (counterpart of ``paddlescience_tpu/nn/recurrent.py``):
an LSTM over (B, T, F) sequences, a convolutional LSTM cell and the pixel
shuffle.

* :class:`LSTM` keeps the JAX layout: one (in + H, 4H) weight ``w`` and
  one bias ``b`` of 4H, the gates in the order i, f, g, o, so
  ``utils/jax_params.py::load_jax_params`` carries it across unchanged.
  The JAX layer scans z_t = [x_t, h_{t-1}] @ w + b. Here the input half,
  x @ w[:F] + b, is one product over every time step, and each step adds
  h_{t-1} @ w[F:] with one ``addmm``: a plain loop (cuDNN's LSTM splits
  the weight and is another computation).
* :class:`ConvLSTMCell` is the JAX cell on channel-first tensors (the
  port's ``Conv`` is channel-first): an input conv of 4C channels (any
  kernel, stride and padding) plus a bias-free 3x3 "SAME" hidden conv,
  the gates split along the channels in the order i, f, g, o.
* :func:`pixel_shuffle` is the JAX function on channel-first tensors. The
  JAX one is channel-last and reads output channel c at offset (i, j) from
  input channel (i r + j) C' + c; ``F.pixel_shuffle`` reads c r^2 + i r +
  j, which is the same only for C' = 1.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from paddlescience_torch.nn.layers import Conv

__all__ = ["LSTM", "ConvLSTMCell", "pixel_shuffle", "lstm_gates"]


def lstm_gates(z: torch.Tensor, c: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM update from the pre-activations ``z`` (i, f, g, o stacked
    along ``dim``) and the cell ``c``: returns (h, c)."""
    i, f, g, o = torch.chunk(z, 4, dim=dim)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class LSTM(nn.Module):
    """Single-layer LSTM, (B, T, F) -> (B, T, H); ``w`` and ``b`` drawn
    U(-1/sqrt(H), 1/sqrt(H)) and zero, as in the JAX layer."""

    def __init__(self, input_size: int, hidden_size: int, *, generator: torch.Generator):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        k = 1.0 / math.sqrt(hidden_size)
        self.w = nn.Parameter(torch.empty(input_size + hidden_size, 4 * hidden_size).uniform_(-k, k,
                                                                                              generator=generator))
        self.b = nn.Parameter(torch.zeros(4 * hidden_size))

    def forward(self, x: torch.Tensor, init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        B, T, F = x.shape
        if init_state is None:
            h = c = x.new_zeros(B, self.hidden_size)
        else:
            h, c = init_state
        xw = torch.addmm(self.b, x.reshape(B * T, F), self.w[:F]).reshape(B, T, -1)
        w_h = self.w[F:]
        hs = []
        for t in range(T):
            h, c = lstm_gates(torch.addmm(xw[:, t], h, w_h), c)
            hs.append(h)
        return torch.stack(hs, dim=1)


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell over channel-first states (B, C, H, W).
    ``padding_mode`` pads both convolutions ("zeros": the JAX cell's
    "SAME" hidden convolution; PhyCRNet's cell pads circularly)."""

    def __init__(self, input_channels: int, hidden_channels: int, input_kernel_size: int, input_stride: int = 1,
                 input_padding=0, *, padding_mode: str = "zeros", generator: torch.Generator):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.input_stride = input_stride
        self.conv_x = Conv(input_channels, 4 * hidden_channels, (input_kernel_size, input_kernel_size),
                           strides=input_stride, padding=input_padding, padding_mode=padding_mode,
                           generator=generator)
        self.conv_h = Conv(hidden_channels, 4 * hidden_channels, (3, 3), padding=1, padding_mode=padding_mode,
                           bias=False, generator=generator)

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        h, c = state
        h, c = lstm_gates(self.conv_x(x) + self.conv_h(h), c, dim=1)
        return h, (h, c)

    def init_state(self, x_shape) -> Tuple[torch.Tensor, torch.Tensor]:
        B, _, H, W = x_shape
        s = self.input_stride
        shape = (B, self.hidden_channels, H // s, W // s)
        w = self.conv_x.weight
        return w.new_zeros(shape), w.new_zeros(shape)


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """(B, C' r^2, H, W) -> (B, C', H r, W r): output (c, h r + i, w r + j)
    reads input channel (i r + j) C' + c at (h, w), the JAX function's
    channel order."""
    B, C, H, W = x.shape
    r = upscale
    x = x.reshape(B, r, r, C // (r * r), H, W).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C // (r * r), H * r, W * r)
