"""AFNONet and PrecipNet, the FourCastNet weather surrogates (counterpart
of ``paddlescience_tpu/arch/afno.py``).

A patch embedding (a strided conv, plus ``pos_embed``), ``depth`` blocks
of LayerNorm -> ``AFNO2D`` (+ the residual) -> LayerNorm -> MLP -> drop
path (+ the residual), a LayerNorm and a linear head whose columns are
reshaped back onto the (C, H, W) grid. ``AFNO2D`` mixes the patch grid in
Fourier space: the orthonormal rFFT over (h, w), a complex two-layer MLP
per channel block (``w1``, ``b1``, ``w2``, ``b2``, real and imaginary
parts stacked first) with soft-shrink on the kept modes
``[:, st:end, :kept]`` (``hard_thresholding_fraction``), zero elsewhere,
and the inverse rFFT (the DC and Nyquist columns' imaginary parts go
unread, by cuFFT as by pocketfft), plus its input. LayerNorm
eps is 1e-6; GELU is the tanh form. ``num_timestamps`` > 1 rolls the net
out, each output the next input.

Dropout and drop path are active only in training mode with a
``torch.Generator`` in ``dropout_generator`` (None by default): the JAX
net runs them only when handed a key, which its ``__call__`` never does.
``PrecipNet`` puts a second AFNONet and a 3 x 3 conv head (periodic in
longitude, zero-padded in latitude, ReLU) over a frozen wind model.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.fno import gelu_tanh
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, LayerNorm, Linear

__all__ = ["AFNO2D", "AFNONet", "PrecipNet"]


def _softshrink(x: torch.Tensor, lam: float) -> torch.Tensor:
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam, torch.zeros_like(x)))


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator``."""
    if rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - rate
    return torch.where(keep, x / (1 - rate), torch.zeros_like(x))


def _drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth over the batch axis."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class AFNO2D(nn.Module):
    """The adaptive Fourier mixer of a (B, H, W, C) tensor."""

    def __init__(self, hidden_size: int, num_blocks: int = 8, sparsity_threshold: float = 0.01,
                 hard_thresholding_fraction: float = 1.0, hidden_size_factor: int = 1, scale: float = 0.02, *,
                 generator: torch.Generator):
        super().__init__()
        if hidden_size % num_blocks != 0:
            raise ValueError(f"hidden_size({hidden_size}) should be divisible by num_blocks({num_blocks}).")
        self.hidden_size = hidden_size
        self.num_blocks = num_blocks
        self.block_size = hidden_size // num_blocks
        self.sparsity_threshold = sparsity_threshold
        self.hard_thresholding_fraction = hard_thresholding_fraction
        bsf = self.block_size * hidden_size_factor
        g = generator
        self.w1 = nn.Parameter(scale * torch.randn((2, num_blocks, self.block_size, bsf), generator=g))
        self.b1 = nn.Parameter(scale * torch.randn((2, num_blocks, bsf), generator=g))
        self.w2 = nn.Parameter(scale * torch.randn((2, num_blocks, bsf, self.block_size), generator=g))
        self.b2 = nn.Parameter(scale * torch.randn((2, num_blocks, self.block_size), generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = x
        B, H, W, C = x.shape
        xf = torch.fft.rfft2(x, dim=(1, 2), norm="ortho").reshape(B, H, W // 2 + 1, self.num_blocks, self.block_size)
        total_modes = H // 2 + 1
        kept = int(total_modes * self.hard_thresholding_fraction)
        st, end = total_modes - kept, total_modes + kept
        sel = xf[:, st:end, :kept]
        xr, xi = sel.real, sel.imag
        mix = lambda a, w: torch.einsum("xyzbi,bio->xyzbo", a, w)
        o1r = F.relu(mix(xr, self.w1[0]) - mix(xi, self.w1[1]) + self.b1[0])
        o1i = F.relu(mix(xi, self.w1[0]) + mix(xr, self.w1[1]) + self.b1[1])
        o2r = mix(o1r, self.w2[0]) - mix(o1i, self.w2[1]) + self.b2[0]
        o2i = mix(o1i, self.w2[0]) + mix(o1r, self.w2[1]) + self.b2[1]
        kept_c = torch.complex(_softshrink(o2r, self.sparsity_threshold), _softshrink(o2i, self.sparsity_threshold))
        out = torch.zeros_like(xf)
        out[:, st:end, :kept] = kept_c
        y = torch.fft.irfftn(out.reshape(B, H, W // 2 + 1, C), s=(H, W), dim=(1, 2), norm="ortho")
        return y + bias


class _Mlp(nn.Module):
    """fc1 -> GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_f: int, hidden_f: int, drop: float = 0.0, *, generator: torch.Generator):
        super().__init__()
        self.fc1 = Linear(in_f, hidden_f, generator=generator)
        self.fc2 = Linear(hidden_f, in_f, generator=generator)
        self.drop = drop

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = _dropout(gelu_tanh(self.fc1(x)), self.drop, generator)
        return _dropout(self.fc2(h), self.drop, generator)


class _AFNOBlock(nn.Module):
    def __init__(self, dim: int, num_blocks: int, sparsity_threshold: float, hard_frac: float, mlp_ratio: float,
                 drop: float = 0.0, drop_path: float = 0.0, double_skip: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.norm1 = LayerNorm(dim, epsilon=1e-6)
        self.filter = AFNO2D(dim, num_blocks, sparsity_threshold, hard_frac, generator=generator)
        self.norm2 = LayerNorm(dim, epsilon=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), drop, generator=generator)
        self.double_skip = double_skip
        self.drop_path = drop_path

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        residual = x
        h = self.filter(self.norm1(x))
        if self.double_skip:
            h = h + residual
            residual = h
        y = _drop_path(self.mlp(self.norm2(h), generator), self.drop_path, generator)
        return y + residual


class AFNONet(Arch):
    """FourCastNet backbone: (B, C, H, W) -> (B, out_channels, H, W), rolled
    out ``num_timestamps`` steps (one output key a step)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...],
                 img_size: Tuple[int, int] = (720, 1440), patch_size: Tuple[int, int] = (8, 8), in_channels: int = 20,
                 out_channels: int = 20, embed_dim: int = 768, depth: int = 12, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0, num_blocks: int = 8,
                 sparsity_threshold: float = 0.01, hard_thresholding_fraction: float = 1.0, num_timestamps: int = 1,
                 *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.img_size = tuple(img_size)
        self.patch_size = tuple(patch_size)
        self.out_channels = out_channels
        self.num_timestamps = num_timestamps
        self.h = img_size[0] // patch_size[0]
        self.w = img_size[1] // patch_size[1]
        self.dropout_generator: Optional[torch.Generator] = None
        self.patch_proj = Conv(in_channels, embed_dim, patch_size, strides=patch_size, padding="VALID", generator=g)
        pos = torch.empty((1, self.h * self.w, embed_dim))
        nn.init.trunc_normal_(pos, 0.0, 0.02, -2.0, 2.0, generator=g)
        self.pos_embed = nn.Parameter(pos)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, depth)]  # stochastic depth rises over the blocks
        self.blocks = nn.ModuleList(
            _AFNOBlock(embed_dim, num_blocks, sparsity_threshold, hard_thresholding_fraction, mlp_ratio,
                       drop=drop_rate, drop_path=dpr[i], generator=g) for i in range(depth))
        self.norm = LayerNorm(embed_dim, epsilon=1e-6)
        self.head = Linear(embed_dim, out_channels * patch_size[0] * patch_size[1], bias=False, generator=g)
        self.to(resolve_device(device))

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        gen = self.dropout_generator if self.training else None
        h = self.patch_proj(x).permute(0, 2, 3, 1)  # (B, h, w, E)
        h = (h.reshape(B, -1, h.shape[-1]) + self.pos_embed).reshape(B, self.h, self.w, -1)
        for block in self.blocks:
            h = block(h, gen)
        h = self.head(self.norm(h))  # (B, h, w, C p p)
        ph, pw = self.patch_size
        h = h.reshape(B, self.h, self.w, ph, pw, self.out_channels)
        return h.permute(0, 5, 1, 3, 2, 4).reshape(B, self.out_channels, self.h * ph, self.w * pw)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inp, result = x[self.input_keys[0]], {}
        for i in range(self.num_timestamps):
            inp = result[self.output_keys[i]] = self.forward_tensor(inp)
        return result


class PrecipNet(Arch):
    """A precipitation head over a frozen AFNONet wind model."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], wind_model: AFNONet,
                 img_size: Tuple[int, int] = (720, 1440), patch_size: Tuple[int, int] = (8, 8), in_channels: int = 20,
                 out_channels: int = 1, embed_dim: int = 768, depth: int = 12, mlp_ratio: float = 4.0,
                 num_blocks: int = 8, num_timestamps: int = 1, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(1)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.num_timestamps = num_timestamps
        self.wind_model = wind_model
        self.backbone = AFNONet(("x",), ("y",), img_size=img_size, patch_size=patch_size, in_channels=in_channels,
                                out_channels=out_channels, embed_dim=embed_dim, depth=depth, mlp_ratio=mlp_ratio,
                                num_blocks=num_blocks, generator=g, device="cpu")
        self.conv = Conv(out_channels, out_channels, (3, 3), padding="VALID", generator=g)
        self.to(resolve_device(device))

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        h = self.backbone.forward_tensor(x)  # (B, C, H, W)
        h = torch.cat([h[..., -1:], h, h[..., :1]], dim=-1)  # periodic in longitude
        h = F.pad(h, (0, 0, 1, 1))  # zero in latitude
        return F.relu(self.conv(h))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inp, result = x[self.input_keys[0]], {}
        for i in range(self.num_timestamps):
            with torch.no_grad():  # the wind model is frozen
                wind = self.wind_model.forward_tensor(inp)
            result[self.output_keys[i]] = self.forward_tensor(wind)
            inp = wind
        return result
