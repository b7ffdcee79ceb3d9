"""Volterra integral equation (counterpart of
``paddlescience_tpu/equation/ide/volterra.py``).

u(t) = f(t) + int_a^t K(t, s) u(s) ds, the integral by Gauss-Legendre
quadrature at each collocation point. ``precompute(x, device)`` builds the
(N, N + N Q) integration matrix on the host from the collocation points
(numpy, as the JAX package does), puts it on ``device`` once, and returns
the extended inputs (the N points, then their N Q quadrature points); the
residual is then one matrix product with the net's outputs on them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from paddlescience_torch.autodiff.ad import unwrap
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.base import PDE

__all__ = ["Volterra"]


class Volterra(PDE):
    dtype = np.float32

    def __init__(self, bound: float, num_points: int, quad_deg: int, kernel_func: Callable, func: Callable):
        super().__init__()
        self.bound = bound
        self.num_points = num_points
        self.quad_deg = quad_deg
        self.kernel_func = kernel_func
        self.func = func
        quad_x, quad_w = np.polynomial.legendre.leggauss(quad_deg)
        self.quad_x = quad_x.astype(self.dtype).reshape(-1, 1)
        self.quad_w = quad_w.astype(self.dtype)
        self._int_mat: Optional[torch.Tensor] = None

        def compute_volterra_func(out):
            u = unwrap(out["u"])
            lhs = unwrap(self.func(out))
            if self._int_mat is None:
                raise RuntimeError("Volterra.precompute(x) must be called with the collocation points before "
                                   "evaluating the equation (static quadrature matrix)")
            rhs = self._int_mat @ u
            return lhs[: rhs.shape[0]] - rhs

        self.add_equation("volterra", compute_volterra_func)

    def get_quad_points(self, t: np.ndarray) -> np.ndarray:
        """Gauss-Legendre nodes mapped from [-1, 1] to [a, t] per row: (N, Q)."""
        a, b = self.bound, t
        return ((b - a) / 2) @ self.quad_x.T + (b + a) / 2

    def _get_quad_weights(self, t: float) -> np.ndarray:
        a, b = self.bound, t
        return (b - a) / 2 * self.quad_w

    def _get_int_matrix(self, x: np.ndarray) -> np.ndarray:
        """(N, N + N Q): row i integrates K(x_i, s) u(s) over the quadrature
        points appended after the N collocation points."""
        n, q = self.num_points, self.quad_deg
        int_mat = np.zeros((n, n + n * q), dtype=self.dtype)
        for i in range(n):
            xi = float(np.ravel(x[i])[0])
            k = np.ravel(self.kernel_func(np.full((q, 1), xi), self.get_quad_points(np.array([[xi]])).T))
            int_mat[i, n + q * i : n + q * (i + 1)] = self._get_quad_weights(xi) * k
        return int_mat

    def precompute(self, x: np.ndarray, device: DeviceLike = None) -> np.ndarray:
        """Build the integration matrix for the collocation points ``x``
        (the first ``num_points`` rows) on ``device`` (CUDA when None), and
        return the model's inputs: the points and their quadrature points,
        (N + N Q, 1)."""
        x = np.asarray(x).reshape(-1, 1)[: self.num_points]
        self._int_mat = torch.as_tensor(self._get_int_matrix(x), device=resolve_device(device))
        quad_pts = self.get_quad_points(x).reshape(-1, 1)
        return np.concatenate([x, quad_pts], axis=0).astype(self.dtype)
