"""Real spherical harmonics transforms (counterpart of
``paddlescience_tpu/arch/sht.py``).

Analysis: the FFT over longitude (kept up to ``mmax``), then per (l, m) a
Legendre-weighted sum over latitude, with the quadrature weights and
2 pi / nlon folded into the table. Synthesis: the inverse contraction,
zero-padding up to nlon / 2 + 1 longitudinal modes, and the inverse real
FFT scaled by nlon (the DC and Nyquist modes' imaginary parts go unread,
by cuFFT as by pocketfft). The orthonormal associated
Legendre tables (:func:`precompute_legpoly`) and the quadrature rules are
the JAX package's numpy code, copied; they are built in float64 at
construction and kept as float32 buffers. The grid names are the JAX
package's, and so is its reading of them: "legendre-gauss" and "lobatto"
both take the Gauss-Legendre nodes and weights, "equiangular" the
Clenshaw-Curtis ones.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


__all__ = ["RealSHT", "InverseRealSHT", "legendre_gauss_weights", "clenshaw_curtiss_weights", "precompute_legpoly"]


def legendre_gauss_weights(n: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Legendre nodes and weights on [a, b]."""
    xlg, wlg = np.polynomial.legendre.leggauss(n)
    return (b - a) * 0.5 * xlg + (b + a) * 0.5, wlg * (b - a) * 0.5


def clenshaw_curtiss_weights(n: int, a: float = -1.0, b: float = 1.0):
    """Clenshaw-Curtis nodes and weights of the equiangular grid."""
    tj = np.pi * np.arange(n) / (n - 1)
    xcc = np.cos(tj)
    wcc = np.zeros(n)
    for j in range(n):
        s = 0.0
        for k in range(1, (n - 1) // 2 + 1):
            ck = 1.0 if 2 * k == n - 1 else 2.0
            s += ck / (4 * k * k - 1) * np.cos(2 * k * tj[j])
        w = 1.0 - s
        w *= 2.0 / (n - 1)
        if j in (0, n - 1):
            w *= 0.5
        wcc[j] = w
    xcc = (b - a) * 0.5 * xcc + (b + a) * 0.5
    wcc = wcc * (b - a) * 0.5
    return xcc[::-1].copy(), wcc[::-1].copy()


def precompute_legpoly(mmax: int, lmax: int, x: np.ndarray) -> np.ndarray:
    """The orthonormalised associated Legendre table P_l^m(x), (mmax, lmax,
    nlat), by the stable recurrence in m then l, in float64."""
    nlat = len(x)
    x = np.asarray(x, np.float64)
    sinx = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    p = np.zeros((mmax, lmax, nlat), np.float64)
    p00 = math.sqrt(1.0 / (4.0 * math.pi))
    for m in range(mmax):
        if m == 0:
            pmm = np.full(nlat, p00)
        else:
            pmm = prev_mm * (-np.sqrt((2 * m + 1) / (2.0 * m))) * sinx
        prev_mm = pmm
        if m < lmax:
            p[m, m] = pmm
        if m + 1 < lmax:
            p[m, m + 1] = np.sqrt(2 * m + 3.0) * x * pmm
        for l in range(m + 2, lmax):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = -np.sqrt(((2.0 * l + 1.0) * (l - 1.0 + m) * (l - 1.0 - m)) / ((2.0 * l - 3.0) * (l * l - m * m)))
            p[m, l] = a * x * p[m, l - 1] + b * p[m, l - 2]
    return p


def _nodes(grid: str, nlat: int):
    if grid in ("legendre-gauss", "lobatto"):  # the JAX package takes Gauss-Legendre for both
        return legendre_gauss_weights(nlat)
    if grid == "equiangular":
        return clenshaw_curtiss_weights(nlat)
    raise ValueError(f"unknown grid '{grid}'")


class RealSHT(nn.Module):
    """(..., nlat, nlon) real -> (..., lmax, mmax) complex."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None, mmax: Optional[int] = None,
                 grid: str = "lobatto", norm: str = "ortho", csphase: bool = True):
        super().__init__()
        self.nlat, self.nlon = nlat, nlon
        self.grid, self.norm = grid, norm
        self.lmax = lmax or nlat
        self.mmax = mmax or nlon // 2 + 1
        cost, w = _nodes(grid, nlat)
        weights = precompute_legpoly(self.mmax, self.lmax, cost) * w[None, None, :] * (2 * np.pi / nlon)
        self.register_buffer("weights", torch.from_numpy(weights.astype(np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = torch.fft.rfft(x, dim=-1)[..., : self.mmax]  # (..., nlat, mmax)
        w = self.weights.to(xf.dtype)
        return torch.einsum("...tm,mlt->...lm", xf, w)


class InverseRealSHT(nn.Module):
    """(..., lmax, mmax) complex -> (..., nlat, nlon) real."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None, mmax: Optional[int] = None,
                 grid: str = "lobatto", norm: str = "ortho", csphase: bool = True):
        super().__init__()
        self.nlat, self.nlon = nlat, nlon
        self.lmax = lmax or nlat
        self.mmax = mmax or nlon // 2 + 1
        cost, _ = _nodes(grid, nlat)
        self.register_buffer("pct", torch.from_numpy(precompute_legpoly(self.mmax, self.lmax, cost).astype(np.float32)))

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        xf = torch.einsum("...lm,mlt->...tm", coeffs, self.pct.to(coeffs.dtype))  # (..., nlat, mmax)
        nfreq = self.nlon // 2 + 1
        if self.mmax < nfreq:
            xf = F.pad(xf, (0, nfreq - self.mmax))
        return torch.fft.irfft(xf, n=self.nlon, dim=-1) * self.nlon
