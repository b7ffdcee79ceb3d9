"""Fractional Poisson equation (counterpart of
``paddlescience_tpu/equation/fpde/fractional_poisson.py``).

(-Laplace)^(alpha / 2) u = f on a 2-D geometry, by the directional
Grünwald-Letnikov discretisation: the fractional Laplacian at x is the
average over ``n_theta`` ray directions of one-sided GL differences with
step h up to the boundary (the unit disk's ray length, as in the JAX
package). ``precompute(x, device)`` builds the (N, N + N n_theta n_r)
matrix on the host (numpy float64, stored as float32 on ``device``) and
returns the extended point set; the residual is one matrix product.

The canonical problem: the unit disk with exact solution
u = (1 - |x|^2)^(1 + alpha / 2) and
f = 2^alpha Gamma(2 + alpha / 2) Gamma(1 + alpha / 2) (1 - (1 + alpha / 2) |x|^2).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.autodiff.ad import unwrap
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.base import PDE

__all__ = ["FractionalPoisson"]


class FractionalPoisson(PDE):
    dtype = np.float32

    def __init__(self, alpha: float, geom, resolution: Tuple[int, ...] = (8, 100)):
        from scipy import special

        super().__init__()
        self.alpha = alpha
        self.geom = geom
        self.n_theta, self.n_r = resolution
        self._int_mat: Optional[torch.Tensor] = None
        self._n_points: Optional[int] = None

        w = [1.0]  # GL weights w_0 = 1, w_k = w_{k-1} (k - 1 - alpha) / k
        for k in range(1, self.n_r + 1):
            w.append(w[-1] * (k - 1 - alpha) / k)
        self._w = np.asarray(w, np.float64)
        self._c_norm = special.gamma((1 - alpha) / 2.0) * special.gamma((2 + alpha) / 2.0) / (2 * np.pi**1.5)
        rhs_scale = 2**alpha * float(special.gamma(2 + alpha / 2)) * float(special.gamma(1 + alpha / 2))

        def compute_fpde_func(out):
            u = unwrap(out["u"])
            if self._int_mat is None:
                raise RuntimeError("FractionalPoisson.precompute(x) must be called with the collocation points "
                                   "before evaluating the equation")
            lhs = (self._int_mat @ u)[:, 0]
            x = torch.cat([unwrap(out["x"]), unwrap(out["y"])], dim=1)[: lhs.shape[0]]
            rhs = rhs_scale * (1 - (1 + self.alpha / 2) * torch.sum(x**2, dim=1))
            return (lhs - rhs)[:, None]

        self.add_equation("fpde", compute_fpde_func)

    def precompute(self, x: np.ndarray, device: DeviceLike = None) -> np.ndarray:
        """Build the GL matrix for the collocation points ``x`` (N, 2) on
        ``device`` (CUDA when None) and return the extended point set
        (N + N n_theta n_r, 2) whose model outputs feed the residual."""
        x = np.asarray(x, np.float64)
        n = len(x)
        self._n_points = n
        thetas = np.linspace(0, 2 * np.pi, self.n_theta, endpoint=False)
        dirs = np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
        extended = [x]
        rows, cols, vals = [], [], []
        col_ofs = n
        dtheta = 2 * np.pi / self.n_theta
        steps = np.arange(1, self.n_r + 1)
        for i in range(n):
            xi = x[i]
            for t in range(self.n_theta):
                d = dirs[t]
                b = xi @ d
                c = xi @ xi - 1.0
                length = -b + math.sqrt(max(b * b - c, 0.0))  # |xi - L d| = 1 on the unit disk
                h = length / self.n_r
                if h <= 0:
                    continue
                scale = dtheta * self._c_norm / max(h, 1e-12) ** self.alpha
                rows.append(i)  # w_0 couples the collocation point itself
                cols.append(i)
                vals.append(scale * self._w[0])
                extended.append(xi[None, :] - steps[:, None] * h * d[None, :])
                rows.extend([i] * self.n_r)
                cols.extend(range(col_ofs, col_ofs + self.n_r))
                vals.extend(scale * self._w[1:])
                col_ofs += self.n_r
        all_pts = np.concatenate(extended, axis=0)
        mat = np.zeros((n, len(all_pts)), np.float64)
        np.add.at(mat, (np.asarray(rows), np.asarray(cols)), np.asarray(vals))  # the diagonal sums over directions
        self._int_mat = torch.as_tensor(mat.astype(np.float32), device=resolve_device(device))
        return all_pts.astype(self.dtype)
