"""The tempoGAN generator and discriminator (counterpart of
``paddlescience_tpu/arch/gan.py``).

Channel-first (B, C, H, W) in and out. The generator is a chain of
variant residual blocks (a stack of "SAME" convolutions, each with its
activation, plus a 1x1 shortcut convolution strided by the product of the
stack's strides); the discriminator a conv pyramid and a Linear head.
As in the JAX module: ``leaky_relu`` has slope 0.2 here (not the
registry's 0.01); ``use_bns`` is accepted and unused; a strided "SAME"
convolution pads as XLA does, the extra row at the end
(``nn/layers.py::same_padding``); the kernels start N(0, 0.04); and the
discriminator flattens its last feature map in the JAX module's
channel-last order (H, W, C) before ``fc``, so the carried ``fc`` weights
read the same features. Parameter names follow the JAX module
(``blocks.0.convs.1.weight``, ``blocks.2.shortcut.bias``, ``fc.weight``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch import base
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, Linear

__all__ = ["Generator", "Discriminator"]

_ACTS = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    None: lambda x: x,
    "none": lambda x: x,
}


def _conv(c_in, c_out, k, s, g: torch.Generator) -> Conv:
    conv = Conv(c_in, c_out, (k, k), strides=s, padding="SAME", generator=g)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.04, generator=g)
    return conv


class _VariantResBlock(nn.Module):
    """Conv stack plus a 1x1 shortcut convolution of the block's input."""

    def __init__(self, in_channel, out_channels, kernel_sizes, strides, use_bns, acts, *, generator: torch.Generator):
        super().__init__()
        convs, c_in = [], in_channel
        for c_out, k, s in zip(out_channels, kernel_sizes, strides):
            convs.append(_conv(c_in, c_out, k, s, generator))
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.acts = [_ACTS[a] for a in acts]
        total_stride = 1
        for s in strides:
            total_stride *= s
        self.shortcut = _conv(in_channel, out_channels[-1], 1, total_stride, generator)

    def forward(self, x):
        h = x
        for conv, act in zip(self.convs, self.acts):
            h = act(conv(h))
        return h + self.shortcut(x)


class Generator(base.Arch):
    """``input_keys[0]`` (B, in_channel, H, W) -> ``output_keys[0]``."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], in_channel: int,
                 out_channels_tuple: Sequence[Sequence[int]], kernel_sizes_tuple: Sequence[Sequence[int]],
                 strides_tuple: Sequence[Sequence[int]], use_bns_tuple: Sequence[Sequence[bool]],
                 acts_tuple: Sequence[Sequence[Optional[str]]], *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        blocks, c_in = [], in_channel
        for i in range(len(out_channels_tuple)):
            blocks.append(_VariantResBlock(c_in, out_channels_tuple[i], kernel_sizes_tuple[i], strides_tuple[i],
                                           use_bns_tuple[i], acts_tuple[i], generator=g))
            c_in = out_channels_tuple[i][-1]
        self.blocks = nn.ModuleList(blocks)
        self.to(device)

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {self.output_keys[0]: self.forward_tensor(x[self.input_keys[0]])}


class Discriminator(base.Arch):
    """Each input key's image -> its feature maps after every convolution
    and the score; the outputs, in that order over the input keys, take
    ``output_keys`` in turn."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], in_channel: int,
                 out_channels: Sequence[int], fc_channel: int, kernel_sizes: Sequence[int], strides: Sequence[int],
                 use_bns: Sequence[bool], acts: Sequence[Optional[str]], *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        convs, c_in = [], in_channel
        for c_out, k, s in zip(out_channels, kernel_sizes, strides):
            convs.append(_conv(c_in, c_out, k, s, g))
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.acts = [_ACTS[a] for a in acts]
        self.fc = Linear(fc_channel, 1, generator=g)
        self.to(device)

    def forward_tensor(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for conv, act in zip(self.convs, self.acts):
            x = act(conv(x))
            feats.append(x)
        score = self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))  # the JAX module's (H, W, C) order
        return feats + [score]

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        outs: List[torch.Tensor] = []
        for key in self.input_keys:
            outs.extend(self.forward_tensor(x[key]))
        return dict(zip(self.output_keys, outs))
