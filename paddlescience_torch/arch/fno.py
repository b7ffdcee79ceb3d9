"""Fourier neural operators (counterpart of ``paddlescience_tpu/arch/fno.py``):
``SpectralConv`` (dense, CP, Tucker and separable weights), ``FNOBlocks``,
``DomainPadding``, ``FNONet`` and ``TFNO1d/2d/3dNet``.

Layout as in the JAX package: tensors are channel-first (B, C, *spatial);
a complex weight is two real parameters ``<name>_re`` and ``<name>_im``
(so optimizers, weight decay and ``utils/jax_params.py`` see real tensors
under the JAX names); a channel dense layer holds W of shape (in, out).

Mode semantics: ``n_modes[d]`` counts the Fourier modes kept along axis d
in total: ``n // 2`` non-negative and ``n // 2`` negative frequencies on
the full-FFT axes (one weight "corner" per sign combination), ``n // 2 +
1`` coefficients on the last, real-FFT axis. On a grid too small for the
configured modes each corner keeps what the grid has (``min(modes, (size +
1) // 2)`` non-negative, ``min(modes, size // 2)`` negative frequencies)
and reads the matching rows of its weight: the high corner's rows are the
frequencies -modes..-1, so it reads the last ones. The spectra are
``torch.fft.rfftn``/``irfftn`` with ``norm="forward"`` by default; each
corner is one complex contraction over channels (``torch.einsum``; the JAX
package computes these with ``jnp.einsum`` too, with no kernel of its
own). ``non_linearity`` defaults to GELU in its tanh form, the default of
``jax.nn.gelu``.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.device import DeviceLike, resolve_device

__all__ = ["SpectralConv", "FNOBlocks", "DomainPadding", "FNONet", "TFNO1dNet", "TFNO2dNet", "TFNO3dNet"]

_MODE_AX = "jklmn"  # einsum letters for up to 5 spatial mode axes


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _normal(shape, scale: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(scale * torch.randn(shape, generator=generator))


class SpectralConv(nn.Module):
    """N-D spectral convolution keeping ``n_modes`` Fourier modes, one
    weight per spectral corner (``factorization`` None/"dense", "cp" or
    "tucker"; ``separable``: one weight per channel, dense only)."""

    def __init__(self, in_channels: int, out_channels: int, n_modes: Sequence[int], separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 1.0, fft_norm: str = "forward", *,
                 generator: torch.Generator):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_modes = tuple(n_modes)
        self.ndim = len(self.n_modes)
        self.separable = separable
        self.fft_norm = fft_norm
        self.factorization = (factorization or "dense").lower()
        self.corner_modes = tuple(m // 2 for m in self.n_modes[:-1]) + (self.n_modes[-1] // 2 + 1,)
        # all +/- combinations on the full-FFT axes; the real-FFT axis keeps its non-negative half
        self.corners = list(itertools.product(*[(0, 1)] * (self.ndim - 1)))
        scale = 1.0 / (in_channels * out_channels)
        wshape = ((in_channels,) + self.corner_modes if separable
                  else (in_channels, out_channels) + self.corner_modes)
        if separable and self.factorization != "dense":
            raise ValueError("separable spectral convs support only dense weights")
        self.rank = float(rank)
        g = generator
        for ci, _ in enumerate(self.corners):
            if self.factorization == "dense" or separable:
                self._complex(f"w{ci}", wshape, scale, g)
            elif self.factorization == "cp":
                R = max(1, int(self.rank * math.prod(wshape) / max(sum(wshape), 1)))
                self.cp_rank = R
                s = scale ** (1.0 / (2 + self.ndim))
                for fi, dim in enumerate(wshape):
                    self._complex(f"w{ci}_f{fi}", (dim, R), s, g)
                setattr(self, f"w{ci}_lam_re", nn.Parameter(torch.ones(R)))
                setattr(self, f"w{ci}_lam_im", nn.Parameter(torch.zeros(R)))
            elif self.factorization == "tucker":
                tranks = tuple(max(1, int(math.ceil(self.rank * d))) for d in wshape)
                self.tucker_ranks = tranks
                s = scale ** (1.0 / (2 + self.ndim))
                self._complex(f"w{ci}_core", tranks, s, g)
                for fi, (dim, r) in enumerate(zip(wshape, tranks)):
                    self._complex(f"w{ci}_f{fi}", (dim, r), s, g)
            else:
                raise ValueError(f"unknown factorization '{self.factorization}' (dense|cp|tucker)")

    def _complex(self, name: str, shape, scale: float, generator: torch.Generator) -> None:
        setattr(self, f"{name}_re", _normal(shape, scale, generator))
        setattr(self, f"{name}_im", _normal(shape, scale, generator))

    def _cplx(self, name: str, index=None) -> torch.Tensor:
        re, im = getattr(self, f"{name}_re"), getattr(self, f"{name}_im")
        if index is not None:
            re, im = re[index], im[index]
        return torch.complex(re, im)

    def _contract(self, ci: int, xc: torch.Tensor, wmode_slices: Tuple[slice, ...]) -> torch.Tensor:
        """This corner's weight applied to xc (B, I, *modes) -> (B, O, *modes)
        in factorized form (a CP or Tucker weight is never formed densely)."""
        mx = _MODE_AX[: self.ndim]
        if self.separable:
            return xc * self._cplx(f"w{ci}", (slice(None),) + wmode_slices)[None]
        if self.factorization == "dense":
            w = self._cplx(f"w{ci}", (slice(None), slice(None)) + wmode_slices)
            return torch.einsum(f"bi{mx},io{mx}->bo{mx}", xc, w)
        if self.factorization == "cp":
            lam = self._cplx(f"w{ci}_lam")
            t = torch.einsum(f"bi{mx},ir->br{mx}", xc, self._cplx(f"w{ci}_f0"))
            for d in range(self.ndim):
                f = self._cplx(f"w{ci}_f{2 + d}", wmode_slices[d])  # (m_d, R)
                t = t * f.T.reshape((1, f.shape[1]) + (1,) * d + (f.shape[0],) + (1,) * (self.ndim - d - 1))
            return torch.einsum(f"br{mx},or,r->bo{mx}", t, self._cplx(f"w{ci}_f1"), lam)
        g = self._cplx(f"w{ci}_core")  # Tucker: the core over the mode factors, then the channel factors
        for d in range(self.ndim):
            f = self._cplx(f"w{ci}_f{2 + d}", wmode_slices[d])  # (m_d, r_d)
            g = torch.movedim(torch.tensordot(g, f, dims=([2 + d], [1])), -1, 2 + d)
        t = torch.einsum(f"bi{mx},ip->bp{mx}", xc, self._cplx(f"w{ci}_f0"))
        return torch.einsum(f"bp{mx},pq{mx},oq->bo{mx}", t, g, self._cplx(f"w{ci}_f1"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = tuple(x.shape[2:])
        fft_axes = tuple(range(2, 2 + self.ndim))
        x_hat = torch.fft.rfftn(x, dim=fft_axes, norm=self.fft_norm)
        out_shape = (x.shape[0], self.in_channels if self.separable else self.out_channels) + tuple(x_hat.shape[2:])
        out_hat = torch.zeros(out_shape, dtype=x_hat.dtype, device=x.device)
        for ci, corner in enumerate(self.corners):
            slices, wslices = [slice(None), slice(None)], []
            for d, sign in enumerate(corner):
                cm, size = self.corner_modes[d], spatial[d]
                if sign == 0:
                    m = min(cm, (size + 1) // 2)
                    slices.append(slice(0, m))
                    wslices.append(slice(0, m))
                else:
                    m = min(cm, size // 2)
                    slices.append(slice(x_hat.shape[2 + d] - m, None))
                    wslices.append(slice(cm - m, cm))  # the m lowest |frequencies| of -cm..-1
            m_last = min(self.corner_modes[-1], x_hat.shape[-1])
            slices.append(slice(0, m_last))
            wslices.append(slice(0, m_last))
            slices = tuple(slices)
            out_hat[slices] = self._contract(ci, x_hat[slices], tuple(wslices))
        return torch.fft.irfftn(out_hat, s=spatial, dim=fft_axes, norm=self.fft_norm)


class _SoftGating(nn.Module):
    """A learned per-channel affine skip."""

    def __init__(self, channels: int, ndim: int):
        super().__init__()
        shape = (1, channels) + (1,) * ndim
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x):
        return self.weight * x + self.bias


class _ChannelDense(nn.Module):
    """A 1x1 convolution of channel-first tensors: (B, C, *S) -> (B, C', *S)."""

    def __init__(self, in_channels: int, out_channels: int, *, generator: torch.Generator):
        super().__init__()
        self.weight = _normal((in_channels, out_channels), math.sqrt(1.0 / in_channels), generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        y = torch.einsum("bi...,io->bo...", x, self.weight)
        return y + self.bias.reshape((1, -1) + (1,) * (y.ndim - 2))


def _make_skip(kind, channels_in: int, channels_out: int, ndim: int, generator: torch.Generator) -> nn.Module:
    kind = (kind or "linear").lower() if not isinstance(kind, tuple) else kind[0]
    if kind == "identity":
        return nn.Identity()
    if kind == "linear":
        return _ChannelDense(channels_in, channels_out, generator=generator)
    if kind == "soft-gating":
        return _SoftGating(channels_out, ndim)
    raise ValueError(f"unknown skip type '{kind}'")


class FNOBlocks(nn.Module):
    """``n_layers`` spectral blocks with skips and an optional channel MLP:
    block k is act(conv_k(x) + skip_k(x)) (no activation after the last
    block unless the MLP follows)."""

    def __init__(self, in_channels: int, out_channels: int, n_modes: Sequence[int], n_layers: int = 4,
                 use_mlp: bool = False, mlp: Optional[Dict[str, float]] = None, non_linearity: Callable = gelu_tanh,
                 fno_skip: str = "linear", mlp_skip: str = "soft-gating", separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 1.0, fft_norm: str = "forward", *,
                 generator: torch.Generator):
        super().__init__()
        self.n_layers = n_layers
        self.ndim = len(n_modes)
        self.non_linearity = non_linearity
        self.use_mlp = use_mlp
        g = generator
        self.convs = nn.ModuleList(
            SpectralConv(in_channels, out_channels, n_modes, separable, factorization, rank, fft_norm, generator=g)
            for _ in range(n_layers))
        self.fno_skips = nn.ModuleList(_make_skip(fno_skip, in_channels, out_channels, self.ndim, g)
                                       for _ in range(n_layers))
        if use_mlp:
            hidden = max(int(out_channels * (mlp or {}).get("expansion", 0.5)), 1)
            self.mlp_ins = nn.ModuleList(_ChannelDense(out_channels, hidden, generator=g) for _ in range(n_layers))
            self.mlp_outs = nn.ModuleList(_ChannelDense(hidden, out_channels, generator=g) for _ in range(n_layers))
            self.mlp_skips = nn.ModuleList(_make_skip(mlp_skip, out_channels, out_channels, self.ndim, g)
                                           for _ in range(n_layers))

    def forward(self, x, index: int):
        y = self.convs[index](x) + self.fno_skips[index](x)
        if index < self.n_layers - 1 or self.use_mlp:
            y = self.non_linearity(y)
        if self.use_mlp:
            y = self.mlp_outs[index](self.non_linearity(self.mlp_ins[index](y))) + self.mlp_skips[index](y)
            if index < self.n_layers - 1:
                y = self.non_linearity(y)
        return y


class DomainPadding(nn.Module):
    """Zero-pad each spatial axis by a fraction of its size (at the end,
    ``"one-sided"``, or at both ends) and cut the padding off again."""

    def __init__(self, domain_padding: Union[float, Sequence[float]], mode: str = "one-sided"):
        super().__init__()
        self.padding = domain_padding
        self.mode = mode
        self._unpad = None

    def pad(self, x):
        ndim = x.ndim - 2
        pads = self.padding if isinstance(self.padding, (list, tuple)) else [self.padding] * ndim
        cfg, unpad = [], [slice(None), slice(None)]
        for d, p in enumerate(pads):
            amount = int(round(p * x.shape[2 + d]))
            if self.mode == "one-sided":
                cfg.append((0, amount))
                unpad.append(slice(0, x.shape[2 + d]))
            else:
                cfg.append((amount, amount))
                unpad.append(slice(amount, amount + x.shape[2 + d]))
        self._unpad = tuple(unpad)
        return F.pad(x, [v for pair in reversed(cfg) for v in pair])  # F.pad lists the last axis first

    def unpad(self, x):
        return x[self._unpad]


class FNONet(Arch):
    """N-D (tensorized) Fourier neural operator: lifting (two channel dense
    layers), ``n_layers`` FNO blocks (optionally on a padded domain),
    projection (two more). Input ``input_keys`` concatenated on the channel
    axis; ``norm``, ``preactivation``, ``joint_factorization`` and
    ``implementation`` are accepted and, as in the JAX package, unused."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], n_modes: Tuple[int, ...],
                 hidden_channels: int, in_channels: int = 3, out_channels: int = 1, lifting_channels: int = 256,
                 projection_channels: int = 256, n_layers: int = 4, use_mlp: bool = False,
                 mlp: Optional[Dict[str, float]] = None, non_linearity: Callable = gelu_tanh,
                 norm: Optional[str] = None, preactivation: bool = False, fno_skip: str = "linear",
                 mlp_skip: str = "soft-gating", separable: bool = False, factorization: Optional[str] = None,
                 rank: float = 1.0, joint_factorization: bool = False, implementation: str = "factorized",
                 domain_padding: Optional[Union[list, float, int]] = None, domain_padding_mode: str = "one-sided",
                 fft_norm: str = "forward", patching_levels: int = 0, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, **kwargs):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.n_dim = len(n_modes)
        if patching_levels:
            in_channels = in_channels * patching_levels + 1
        self.lifting_in = _ChannelDense(in_channels, lifting_channels, generator=g)
        self.lifting_out = _ChannelDense(lifting_channels, hidden_channels, generator=g)
        self.projection_in = _ChannelDense(hidden_channels, projection_channels, generator=g)
        self.projection_out = _ChannelDense(projection_channels, out_channels, generator=g)
        self.non_linearity = non_linearity
        self.n_layers = n_layers
        self.fno_blocks = FNOBlocks(hidden_channels, hidden_channels, n_modes, n_layers, use_mlp, mlp, non_linearity,
                                    fno_skip, mlp_skip, separable, factorization, rank, fft_norm, generator=g)
        pads = domain_padding
        active = pads is not None and ((isinstance(pads, (list, tuple)) and sum(pads) > 0)
                                       or (isinstance(pads, (int, float)) and pads > 0))
        self.domain_padding = DomainPadding(pads, domain_padding_mode) if active else None
        self.to(resolve_device(device))

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        x = self.lifting_out(self.non_linearity(self.lifting_in(x)))
        if self.domain_padding is not None:
            x = self.domain_padding.pad(x)
        for index in range(self.n_layers):
            x = self.fno_blocks(x, index)
        if self.domain_padding is not None:
            x = self.domain_padding.unpad(x)
        return self.projection_out(self.non_linearity(self.projection_in(x)))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y = self.concat_to_tensor(x, self.input_keys, axis=1)  # channel-first
        return {self.output_keys[0]: self.forward_tensor(y)}


class TFNO1dNet(FNONet):
    """1-D TFNO."""

    def __init__(self, input_keys, output_keys, n_modes_height: int, hidden_channels: int, **kwargs):
        super().__init__(input_keys, output_keys, (n_modes_height,), hidden_channels, **kwargs)
        self.n_modes_height = n_modes_height


class TFNO2dNet(FNONet):
    """2-D TFNO."""

    def __init__(self, input_keys, output_keys, n_modes_height: int, n_modes_width: int, hidden_channels: int,
                 **kwargs):
        super().__init__(input_keys, output_keys, (n_modes_height, n_modes_width), hidden_channels, **kwargs)


class TFNO3dNet(FNONet):
    """3-D TFNO."""

    def __init__(self, input_keys, output_keys, n_modes_height: int, n_modes_width: int, n_modes_depth: int,
                 hidden_channels: int, **kwargs):
        super().__init__(input_keys, output_keys, (n_modes_height, n_modes_width, n_modes_depth), hidden_channels,
                         **kwargs)
