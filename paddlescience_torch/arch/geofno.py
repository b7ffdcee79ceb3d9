"""FNO1d and the velocity GAN (counterpart of ``paddlescience_tpu/arch/geofno.py``).

``FNO1d`` (channel-last (B, N, C_in) -> (B, output_np, 1)): a lift, the
grid zero-padded by ``padding`` points at the end, four layers of
gelu(spectral(h) + W h), the padding cut, then a fifth spectral conv that
resamples onto ``output_np`` points in Fourier space plus the linear
resize of h onto them, and a two-layer head. A spectral conv keeps
``modes`` rFFT coefficients, mixes channels by a complex weight (``w_re``,
``w_im`` of shape (C, C, modes)), and inverts onto ``n_out`` points scaled
by n_out / N (the DC and Nyquist bins' imaginary parts go unread, by
cuFFT as by pocketfft). GELU is the tanh form.

``VelocityGenerator`` (InversionNet-style: seismic gathers (B, C, T, R) ->
velocity map (B, 1, H, W)): four stride-2 3 x 3 convs with leaky ReLU 0.2,
a linear resize to (H / 4, W / 4), two (nearest x 2, conv) stages, a conv
head, tanh and a linear resize to (H, W). ``VelocityDiscriminator``: three
stride-2 convs, a spatial mean, a linear head. The convs pad "SAME" as XLA
does (``nn/layers.py``: the extra row at the end), the resizes are JAX's
(``nn/resize.py``: the linear one antialiases when it shrinks, nearest is
floor((i + 0.5) in / out)).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.fno import gelu_tanh
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, Linear
from paddlescience_torch.nn.resize import resize

__all__ = ["FNO1d", "VelocityGenerator", "VelocityDiscriminator"]


class _Spectral1d(nn.Module):
    def __init__(self, channels: int, modes: int, *, generator: torch.Generator):
        super().__init__()
        scale = 1.0 / (channels * channels)
        self.w_re = nn.Parameter(scale * torch.randn((channels, channels, modes), generator=generator))
        self.w_im = nn.Parameter(scale * torch.randn((channels, channels, modes), generator=generator))
        self.modes = modes

    def forward(self, x: torch.Tensor, out_size: Optional[int] = None) -> torch.Tensor:
        """(B, N, C) -> (B, out_size or N, C)."""
        n_out = out_size or x.shape[1]
        xh = torch.fft.rfft(x, dim=1)
        m = min(self.modes, xh.shape[1], n_out // 2 + 1)
        w = torch.complex(self.w_re[..., :m], self.w_im[..., :m])
        mixed = torch.einsum("bmi,iom->bmo", xh[:, :m], w)
        out = F.pad(mixed, (0, 0, 0, n_out // 2 + 1 - m))  # zero modes above m
        return torch.fft.irfft(out, n=n_out, dim=1) * (n_out / x.shape[1])


class FNO1d(Arch):
    """1-D FNO over (B, N, C_in) -> a scalar field on ``output_np`` points."""

    def __init__(self, input_key: Tuple[str, ...] = ("input",), output_key: Tuple[str, ...] = ("output",),
                 modes: int = 64, width: int = 64, padding: int = 100, input_channel: int = 2,
                 output_np: int = 2001, *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_key)
        self.output_keys = tuple(output_key)
        self.padding = padding
        self.output_np = output_np
        self.fc0 = Linear(input_channel, width, generator=g)
        self.convs = nn.ModuleList(_Spectral1d(width, modes, generator=g) for _ in range(4))
        self.ws = nn.ModuleList(Linear(width, width, generator=g) for _ in range(4))
        self.conv_out = _Spectral1d(width, modes, generator=g)
        self.fc1 = Linear(width, 128, generator=g)
        self.fc2 = Linear(128, 1, generator=g)
        self.to(resolve_device(device))

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        h = F.pad(self.fc0(x), (0, 0, 0, self.padding))  # (B, N + padding, W)
        for conv, w in zip(self.convs, self.ws):
            h = gelu_tanh(conv(h) + w(h))
        h = h[:, : h.shape[1] - self.padding]
        h = self.conv_out(h, out_size=self.output_np) + resize(h, (h.shape[0], self.output_np, h.shape[2]))
        return self.fc2(gelu_tanh(self.fc1(h)))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {self.output_keys[0]: self.forward_tensor(x[self.input_keys[0]])}


class _VConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int = 3, s: int = 1, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv(c_in, c_out, (k, k), strides=s, padding="SAME", generator=generator)

    def forward(self, x):
        return F.leaky_relu(self.conv(x), 0.2)


class VelocityGenerator(Arch):
    """Seismic gathers (B, C, T, R) -> velocity map (B, 1, H, W)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], in_channels: int = 5,
                 out_size: Tuple[int, int] = (70, 70), dim: int = 32, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, **kwargs):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.out_size = tuple(out_size)
        self.enc = nn.ModuleList([_VConv(in_channels, dim, s=2, generator=g), _VConv(dim, 2 * dim, s=2, generator=g),
                                  _VConv(2 * dim, 4 * dim, s=2, generator=g),
                                  _VConv(4 * dim, 4 * dim, s=2, generator=g)])
        self.dec = nn.ModuleList([_VConv(4 * dim, 2 * dim, generator=g), _VConv(2 * dim, dim, generator=g)])
        self.head = Conv(dim, 1, (3, 3), padding="SAME", generator=g)
        self.to(resolve_device(device))

    def forward_tensor(self, h: torch.Tensor) -> torch.Tensor:
        for e in self.enc:
            h = e(h)
        H, W = self.out_size
        h = resize(h, (h.shape[0], h.shape[1], H // 4, W // 4), "linear")
        for d in self.dec:
            h = d(resize(h, (h.shape[0], h.shape[1], h.shape[2] * 2, h.shape[3] * 2), "nearest"))
        out = torch.tanh(self.head(h))
        return resize(out, (out.shape[0], 1, H, W), "linear")

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {self.output_keys[0]: self.forward_tensor(x[self.input_keys[0]])}


class VelocityDiscriminator(Arch):
    """Conv critic over velocity maps (B, C, H, W) -> (B, 1)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], in_channels: int = 1,
                 dim: int = 32, *, generator: Optional[torch.Generator] = None, device: DeviceLike = None, **kwargs):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(1)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.convs = nn.ModuleList([_VConv(in_channels, dim, s=2, generator=g), _VConv(dim, 2 * dim, s=2, generator=g),
                                    _VConv(2 * dim, 4 * dim, s=2, generator=g)])
        self.head = Linear(4 * dim, 1, generator=g)
        self.to(resolve_device(device))

    def forward_tensor(self, h: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            h = c(h)
        return self.head(h.mean(dim=(2, 3)))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {self.output_keys[0]: self.forward_tensor(x[self.input_keys[0]])}
