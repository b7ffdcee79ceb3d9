"""U-shaped neural operator (counterpart of ``paddlescience_tpu/arch/unonet.py``).

Spectral blocks with per-layer channel widths, mode counts and spatial
scalings (a contracting then an expanding path), with horizontal skips:
the output of layer j, through its own channel skip, is resampled to the
current resolution and joins layer i's input on the channel axis
(``horizontal_skips_map`` {i: j}, by default {n - 1 - j: j} for the first
half). Each layer is conv(h) + skip(h), resampled by its scaling with
:func:`paddlescience_torch.nn.resize` (JAX's linear resize: half-pixel
centres, antialiased when it shrinks), then the non-linearity (GELU in its
tanh form) but after the last layer. The spectral convs, channel-dense
layers and skips are ``arch/fno.py``'s.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.fno import SpectralConv, _ChannelDense, _make_skip, gelu_tanh
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.resize import resize

__all__ = ["UNONet"]


def _resample(x: torch.Tensor, out_spatial) -> torch.Tensor:
    """(B, C, *S) -> (B, C, *out_spatial), linear."""
    if tuple(x.shape[2:]) == tuple(out_spatial):
        return x
    return resize(x, tuple(x.shape[:2]) + tuple(out_spatial), "linear")


class UNONet(Arch):
    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], in_channels: int,
                 out_channels: int, hidden_channels: int, lifting_channels: int = 256, projection_channels: int = 256,
                 n_layers: int = 4, uno_out_channels: Tuple[int, ...] = None,
                 uno_n_modes: Tuple[Tuple[int, ...], ...] = None, uno_scalings: Tuple[Tuple[float, ...], ...] = None,
                 horizontal_skips_map: Optional[Dict] = None, use_mlp: bool = False,
                 mlp: Optional[Dict[str, float]] = None, non_linearity: Callable = gelu_tanh,
                 fno_skip: str = "linear", horizontal_skip: str = "linear", mlp_skip: str = "soft-gating",
                 separable: bool = False, factorization: Optional[str] = None, rank: float = 1.0,
                 fft_norm: str = "forward", *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, **kwargs):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        if uno_out_channels is None or uno_n_modes is None or uno_scalings is None:
            raise ValueError("uno_out_channels/uno_n_modes/uno_scalings can not be None")
        if not (len(uno_out_channels) == len(uno_n_modes) == len(uno_scalings) == n_layers):
            raise ValueError("per-layer specs must all have length n_layers")
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.n_dim = len(uno_n_modes[0])
        self.n_layers = n_layers
        self.uno_scalings = [tuple(s) for s in uno_scalings]
        self.non_linearity = non_linearity
        if horizontal_skips_map is None:
            horizontal_skips_map = {n_layers - i - 1: i for i in range(n_layers // 2)}
        self.horizontal_skips_map = horizontal_skips_map
        self.lifting_in = _ChannelDense(in_channels, lifting_channels, generator=g)
        self.lifting_out = _ChannelDense(lifting_channels, hidden_channels, generator=g)
        convs, skips, h_skips = [], [], {}
        c_in = hidden_channels
        for i in range(n_layers):
            extra = uno_out_channels[horizontal_skips_map[i]] if i in horizontal_skips_map else 0
            convs.append(SpectralConv(c_in + extra, uno_out_channels[i], uno_n_modes[i], separable, factorization,
                                      rank, fft_norm, generator=g))
            skips.append(_make_skip(fno_skip, c_in + extra, uno_out_channels[i], self.n_dim, g))
            if i in horizontal_skips_map.values():
                h_skips[str(i)] = _make_skip(horizontal_skip, uno_out_channels[i], uno_out_channels[i], self.n_dim, g)
            c_in = uno_out_channels[i]
        self.convs = nn.ModuleList(convs)
        self.skips = nn.ModuleList(skips)
        self.h_skips = nn.ModuleDict(h_skips)
        self.projection_in = _ChannelDense(c_in, projection_channels, generator=g)
        self.projection_out = _ChannelDense(projection_channels, out_channels, generator=g)
        self.to(resolve_device(device))

    def forward_tensor(self, h: torch.Tensor) -> torch.Tensor:
        h = self.lifting_out(self.non_linearity(self.lifting_in(h)))
        skip_outputs = {}
        for i in range(self.n_layers):
            if i in self.horizontal_skips_map:
                sk = skip_outputs[self.horizontal_skips_map[i]]
                h = torch.cat([h, _resample(sk, h.shape[2:])], dim=1)
            y = self.convs[i](h) + self.skips[i](h)
            out_spatial = tuple(int(round(s * f)) for s, f in zip(y.shape[2:], self.uno_scalings[i]))
            y = _resample(y, out_spatial)
            if i < self.n_layers - 1:
                y = self.non_linearity(y)
            if i in self.horizontal_skips_map.values():
                skip_outputs[i] = self.h_skips[str(i)](y)
            h = y
        return self.projection_out(self.non_linearity(self.projection_in(h)))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {self.output_keys[0]: self.forward_tensor(self.concat_to_tensor(x, self.input_keys, axis=1))}
