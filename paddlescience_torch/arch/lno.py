"""Laplace neural operator (counterpart of ``paddlescience_tpu/arch/lno.py``:
``Laplace`` and ``LNO``).

The Laplace layer represents a system's transfer function by learned
complex poles (per dimension) and residues: the steady-state response
comes back through an inverse FFT, the transient one through explicit
exp(pole * t) terms on the layer's time and space grids (complex64, as in
the JAX package). Complex weights are ``_re``/``_im`` pairs of real
parameters; the grids ``t_<i>`` and their angular frequencies ``lam_<i>``
are buffers rebuilt from the grids given.

The three contractions of the layer (``eq1``, ``eq2`` and ``eq_x2`` of the
JAX class, each over the input, the residue and one term per dimension)
run as explicit sequences of pairwise contractions: ``jnp.einsum`` orders
a many-operand contraction by opt_einsum, ``torch.einsum`` contracts left
to right unless opt_einsum is installed, and left to right the first pair
of ``eq1`` at the Brusselator shape (batch 50, width 8, 39 x 14 x 14
points, 4 x 4 x 4 modes) holds ~1.6e9 complex entries. The sequences
(:func:`steady_response`, :func:`transient_residues`,
:func:`transient_response`) contract one dimension at a time with the
channels as batch axes, so no intermediate is larger than (B, I, O,
points / n_d, modes_d) and none holds B x I x O x points.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from paddlescience_torch.arch.activation import get_activation
from paddlescience_torch.arch.base import Arch
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Linear

__all__ = ["Laplace", "LNO", "steady_response", "transient_residues", "transient_response"]

_P = "pqr"  # spatial (time, x, y) letters
_M = "mnk"  # mode letters


def steady_response(alpha: torch.Tensor, residue: torch.Tensor, terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """``eq1``: out[b,o,P] = sum_{i,M} alpha[b,i,P] residue[i,o,M]
    prod_d terms[d][P_d,i,o,M_d]. The residue takes the terms one dimension
    at a time (batch over i, o), then the channels are summed per point."""
    D = len(terms)
    P, M = _P[:D], _M[:D]
    h = residue
    for d in range(D):
        h = torch.einsum(f"io{P[:d]}{M[d:]},{P[d]}io{M[d]}->io{P[:d + 1]}{M[d + 1:]}", h, terms[d])
    return torch.einsum(f"bi{P},io{P}->bo{P}", alpha, h)


def transient_residues(alpha: torch.Tensor, residue: torch.Tensor, terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """``eq2``: out[b,o,M] = sum_{i,P} alpha[b,i,P] residue[i,o,M]
    prod_d terms[d][P_d,i,o,M_d]. alpha takes the terms one dimension at a
    time (the first sums the time axis, the longest), then the residue."""
    D = len(terms)
    P, M = _P[:D], _M[:D]
    g = torch.einsum(f"bi{P},{P[0]}io{M[0]}->bio{M[0]}{P[1:]}", alpha, terms[0])
    for d in range(1, D):
        g = torch.einsum(f"bio{M[:d]}{P[d:]},{P[d]}io{M[d]}->bio{M[:d + 1]}{P[d + 1:]}", g, terms[d])
    return torch.einsum(f"bio{M},io{M}->bo{M}", g, residue)


def transient_response(res2: torch.Tensor, exp_terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """``eq_x2``: out[b,o,P] = sum_{i,M} res2[b,i,M] prod_d
    exp_terms[d][i,o,M_d,P_d], one dimension at a time; the last step also
    sums the channels i."""
    D = len(exp_terms)
    P, M = _P[:D], _M[:D]
    if D == 1:
        return torch.einsum(f"bi{M},io{M}{P}->bo{P}", res2, exp_terms[0])
    g = torch.einsum(f"bi{M},io{M[0]}{P[0]}->bio{P[0]}{M[1:]}", res2, exp_terms[0])
    for d in range(1, D - 1):
        g = torch.einsum(f"bio{P[:d]}{M[d:]},io{M[d]}{P[d]}->bio{P[:d + 1]}{M[d + 1:]}", g, exp_terms[d])
    return torch.einsum(f"bio{P[:D - 1]}{M[D - 1]},io{M[D - 1]}{P[D - 1]}->bo{P}", g, exp_terms[D - 1])


class Laplace(nn.Module):
    """N-D pole-residue Laplace operator on (B, C, *spatial) tensors; ``T``
    the time grid (1, nt), ``data`` one grid (1, n_i) per further axis."""

    def __init__(self, in_channels: int, out_channels: int, modes: Tuple[int, ...], T: np.ndarray,
                 data: Tuple[np.ndarray, ...] = (), *, generator: torch.Generator):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.modes = tuple(modes)
        self.dims = len(modes)
        scale = 1.0 / (in_channels * out_channels)

        def u(shape):
            return nn.Parameter(scale * torch.rand(shape, generator=generator))

        for i in range(self.dims):
            setattr(self, f"pole{i}_re", u((in_channels, out_channels, modes[i])))
            setattr(self, f"pole{i}_im", u((in_channels, out_channels, modes[i])))
        res_shape = (in_channels, out_channels) + self.modes
        self.residue_re = u(res_shape)
        self.residue_im = u(res_shape)
        for i, t_i in enumerate((np.asarray(T),) + tuple(np.asarray(d) for d in data)):
            t_i = t_i.reshape(1, -1)
            dt = float(t_i[0, 1] - t_i[0, 0])
            omega = np.fft.fftfreq(t_i.shape[1], d=dt) * 2 * np.pi
            self.register_buffer(f"t_{i}", torch.as_tensor(np.asarray(t_i, np.float32)))
            self.register_buffer(f"lam_{i}", torch.as_tensor(np.asarray(omega, np.float32)))

    def _pole(self, i: int) -> torch.Tensor:
        return torch.complex(getattr(self, f"pole{i}_re"), getattr(self, f"pole{i}_im"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = tuple(x.shape[2:])
        axes = tuple(range(2, 2 + self.dims))
        alpha = torch.fft.fftn(x, dim=axes)
        residue = torch.complex(self.residue_re, self.residue_im)
        terms = []
        for i in range(self.dims):
            lam = torch.complex(torch.zeros_like(getattr(self, f"lam_{i}")), getattr(self, f"lam_{i}"))
            terms.append(1.0 / (lam[:, None, None, None] - self._pole(i)[None]))  # (n_i, in, out, m_i)
        x1 = torch.fft.ifftn(steady_response(alpha, residue, terms), s=spatial, dim=axes).real
        res2 = ((-1) ** self.dims) * transient_residues(alpha, residue, terms)
        exp_terms = []
        for i in range(self.dims):
            t_i = getattr(self, f"t_{i}").to(torch.complex64).reshape(-1)  # (n_i,)
            exp_terms.append(torch.exp(self._pole(i)[..., None] * t_i))  # (in, out, m_i, n_i)
        x2 = transient_response(res2, exp_terms).real / math.prod(spatial)
        return x1 + x2


class LNO(Arch):
    """Laplace neural operator: ``fc0`` lifts the channel-last input to
    ``width`` channels, then act(norm(Laplace(norm(x))) + conv(x)) with a
    1x1 convolution ``conv_w``/``conv_b`` (the norm an instance norm
    without affine parameters: biased variance, eps 1e-5), then ``fc1``
    (activated) and ``fc2`` to one output channel, channel-last."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], width: int, modes: Tuple[int, ...],
                 T: np.ndarray, data: Optional[Tuple[np.ndarray, ...]] = None, in_features: int = 1,
                 hidden_features: int = 64, activation: str = "sin", use_norm: bool = True, use_grid: bool = False,
                 *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.width = width
        self.modes = tuple(modes)
        self.dims = len(modes)
        if self.dims > 3:
            raise ValueError("Only 3 dims and lower of modes are supported now.")
        data = data or ()
        if self.dims != len(data) + 1:
            raise ValueError(f"Dims of modes is {self.dims} but only {len(data)} dims(except T) of data received.")
        self.fc0 = Linear(in_features, width, generator=g)
        self.laplace = Laplace(width, width, self.modes, T, tuple(data), generator=g)
        self.conv_w = nn.Parameter(math.sqrt(1.0 / width) * torch.randn(width, width, generator=g))
        self.conv_b = nn.Parameter(torch.zeros(width))
        self.use_norm = use_norm
        self.norm_eps = 1e-5
        self.fc1 = Linear(width, hidden_features, generator=g)
        self.fc2 = Linear(hidden_features, 1, generator=g)
        self.act = get_activation(activation)
        self.use_grid = use_grid
        self.to(resolve_device(device))

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(2, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.norm_eps)

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc0(x)  # (B, *spatial, width)
        x = torch.movedim(x, -1, 1)  # channel-first for the operator
        x1 = self._norm(self.laplace(self._norm(x))) if self.use_norm else self.laplace(x)
        x2 = torch.einsum("bi...,io->bo...", x, self.conv_w) + self.conv_b.reshape((1, -1) + (1,) * (x.ndim - 2))
        x = torch.movedim(self.act(x1 + x2), 1, -1)
        return self.fc2(self.act(self.fc1(x)))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y = self.concat_to_tensor(x, self.input_keys, axis=-1)
        return {self.output_keys[0]: self.forward_tensor(y)}
