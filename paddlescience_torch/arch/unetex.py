"""UNetEx, the DeepCFD U-Net with one decoder per output channel
(counterpart of ``paddlescience_tpu/arch/unetex.py``; reference
``ppsci/arch/unetex.py:176``).

Channel-first (B, C, H, W) throughout. The encoder's blocks each end in a
2x2 max pool (stride 2, odd edges dropped, as a "VALID" window); each
output channel has its own decoder stack, which resizes to the skip's size
with JAX's nearest rule (``nn/resize.py``) and convolves [skip, upsampled]
("SAME" convolutions, XLA's padding). The pooled gradient goes to the
first maximum of a window in row-major order, where JAX's
``reduce_window`` max sends it as well (windows of tied maxima are common
on clipped densities; ``tests/test_torch_unetex.py`` holds this). The
pool's windows do not overlap, so its backward writes each input once,
and a nearest 2x upsampling reads each input twice: both repeat bitwise
on the card. ``weight_norm`` and ``batch_norm`` are accepted and unused,
as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.device import DeviceLike
from paddlescience_torch.nn.layers import Conv
from paddlescience_torch.nn.resize import resize

__all__ = ["UNetEx"]


def _act(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return {
        "relu": F.relu,
        "tanh": torch.tanh,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
        "sigmoid": torch.sigmoid,
        None: lambda x: x,
    }[name_or_fn]


class _ConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size, layers, activation, *, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(Conv(in_ch if i == 0 else out_ch, out_ch, (kernel_size, kernel_size),
                                        padding="SAME", generator=generator) for i in range(layers))
        self.act = _act(activation)

    def forward(self, x):
        for conv in self.convs:
            x = self.act(conv(x))
        return x


class UNetEx(Arch):
    """``input_key`` (B, in_channel, H, W) -> ``output_key`` (B,
    out_channel, H, W)."""

    def __init__(self, input_key: str, output_key: str, in_channel: int, out_channel: int, kernel_size: int = 3,
                 filters: Tuple[int, ...] = (16, 32, 64), layers: int = 3, weight_norm: bool = True,
                 batch_norm: bool = True, activation="relu", final_activation=None, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        if len(filters) == 0:
            raise ValueError("The filters shouldn't be empty ")
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = (input_key,)
        self.output_keys = (output_key,)
        self.final_activation = _act(final_activation) if final_activation else None
        self.filters = tuple(filters)
        enc, c_in = [], in_channel
        for f in filters:
            enc.append(_ConvBlock(c_in, f, kernel_size, layers, activation, generator=g))
            c_in = f
        self.encoder_blocks = nn.ModuleList(enc)
        decoders = []
        rev = list(filters[::-1])
        for _ in range(out_channel):
            dec = []
            for i, f in enumerate(rev):
                last = i + 1 == len(rev)
                dec.append(_ConvBlock(2 * f, 1 if last else rev[i + 1], kernel_size, layers, activation,
                                      generator=g))
            decoders.append(dec)
        self.decoder_stacks = nn.ModuleList(blk for dec in decoders for blk in dec)
        self._decoders = decoders  # the same modules, per output channel
        if device is not None:
            self.to(device)

    def encode(self, x):
        skips = []
        for block in self.encoder_blocks:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        return x, skips

    def decode(self, x, skips):
        ys = []
        for dec in self._decoders:
            h = x
            sk = list(skips)
            for block in dec:
                skip = sk.pop()
                h = resize(h, (h.shape[0], h.shape[1], skip.shape[2], skip.shape[3]), "nearest")
                h = block(torch.cat([skip, h], dim=1))
            ys.append(h)
        return torch.cat(ys, dim=1)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        h, skips = self.encode(x[self.input_keys[0]])
        h = self.decode(h, skips)
        if self.final_activation is not None:
            h = self.final_activation(h)
        return {self.output_keys[0]: h}
