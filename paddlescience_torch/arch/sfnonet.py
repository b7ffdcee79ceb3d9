"""Spherical Fourier neural operator (counterpart of
``paddlescience_tpu/arch/sfnonet.py``).

A spherical convolution is the real SHT (``arch/sht.py``), a complex
channel mixing per (l, m) (``w_re``, ``w_im`` of shape (in, out, lmax,
mmax)) and the inverse SHT. ``SFNONet`` is ``arch/fno.py``'s lifting,
channel skips and projection around ``n_layers`` of them, with the
optional channel MLP after each; GELU in its tanh form. I/O (B, C, nlat,
nlon).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.fno import _ChannelDense, _make_skip, gelu_tanh
from paddlescience_torch.arch.sht import InverseRealSHT, RealSHT
from paddlescience_torch.device import DeviceLike, resolve_device

__all__ = ["SphericalConv", "SFNONet"]


class SphericalConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_modes: Tuple[int, int], nlat: int, nlon: int,
                 grid: str = "equiangular", separable: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        lmax, mmax = n_modes
        self.lmax, self.mmax = lmax, mmax
        self.sht = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
        self.isht = InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
        scale = 1.0 / (in_channels * out_channels)
        shape = (in_channels, out_channels, lmax, mmax)
        self.w_re = nn.Parameter(scale * torch.randn(shape, generator=generator))
        self.w_im = nn.Parameter(scale * torch.randn(shape, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mixed = torch.einsum("bilm,iolm->bolm", self.sht(x), torch.complex(self.w_re, self.w_im))
        return self.isht(mixed)


class SFNONet(Arch):
    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], n_modes: Tuple[int, int],
                 hidden_channels: int, in_channels: int = 3, out_channels: int = 1, lifting_channels: int = 256,
                 projection_channels: int = 256, n_layers: int = 4, img_size: Tuple[int, int] = (180, 360),
                 grid: str = "equiangular", use_mlp: bool = False, mlp: Optional[Dict[str, float]] = None,
                 non_linearity: Callable = gelu_tanh, fno_skip: str = "linear", separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 1.0, domain_padding=None,
                 domain_padding_mode: str = "one-sided", *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, **kwargs):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        nlat, nlon = img_size
        self.n_layers = n_layers
        self.non_linearity = non_linearity
        self.lifting_in = _ChannelDense(in_channels, lifting_channels, generator=g)
        self.lifting_out = _ChannelDense(lifting_channels, hidden_channels, generator=g)
        self.projection_in = _ChannelDense(hidden_channels, projection_channels, generator=g)
        self.projection_out = _ChannelDense(projection_channels, out_channels, generator=g)
        self.convs = nn.ModuleList(
            SphericalConv(hidden_channels, hidden_channels, tuple(n_modes), nlat, nlon, grid, separable, generator=g)
            for _ in range(n_layers))
        self.skips = nn.ModuleList(_make_skip(fno_skip, hidden_channels, hidden_channels, 2, g)
                                   for _ in range(n_layers))
        self.use_mlp = use_mlp
        if use_mlp:
            hidden = max(int(hidden_channels * (mlp or {}).get("expansion", 0.5)), 1)
            self.mlp_ins = nn.ModuleList(_ChannelDense(hidden_channels, hidden, generator=g) for _ in range(n_layers))
            self.mlp_outs = nn.ModuleList(_ChannelDense(hidden, hidden_channels, generator=g) for _ in range(n_layers))
        self.to(resolve_device(device))

    def forward_tensor(self, h: torch.Tensor) -> torch.Tensor:
        h = self.lifting_out(self.non_linearity(self.lifting_in(h)))
        for i in range(self.n_layers):
            y = self.convs[i](h) + self.skips[i](h)
            if i < self.n_layers - 1:
                y = self.non_linearity(y)
            if self.use_mlp:
                y = y + self.mlp_outs[i](self.non_linearity(self.mlp_ins[i](y)))
            h = y
        return self.projection_out(self.non_linearity(self.projection_in(h)))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {self.output_keys[0]: self.forward_tensor(self.concat_to_tensor(x, self.input_keys, axis=1))}
