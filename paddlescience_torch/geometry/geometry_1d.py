"""1-D geometry: ``Interval`` (counterpart of
``paddlescience_tpu/geometry/geometry_1d.py``, a numpy copy)."""

from __future__ import annotations

import numpy as np

from paddlescience_torch.geometry import geometry, sampler

__all__ = ["Interval"]

_DTYPE = np.float32


class Interval(geometry.Geometry):
    """1-D interval [l, r]."""

    def __init__(self, l: float, r: float):
        super().__init__(1, (np.array([[l]], dtype=_DTYPE), np.array([[r]], dtype=_DTYPE)), r - l)
        self.l = l
        self.r = r

    def is_inside(self, x: np.ndarray) -> np.ndarray:
        return ((self.l <= x) & (x <= self.r)).flatten()

    def on_boundary(self, x: np.ndarray) -> np.ndarray:
        return (np.isclose(x, self.l) | np.isclose(x, self.r)).flatten()

    def boundary_normal(self, x: np.ndarray) -> np.ndarray:
        return (-np.isclose(x, self.l).astype(_DTYPE) + np.isclose(x, self.r).astype(_DTYPE)).reshape(-1, 1)

    def uniform_points(self, n: int, boundary: bool = True) -> np.ndarray:
        if boundary:
            return np.linspace(self.l, self.r, n, dtype=_DTYPE).reshape(-1, 1)
        return np.linspace(self.l, self.r, n + 1, endpoint=False, dtype=_DTYPE)[1:].reshape(-1, 1)

    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        x = sampler.sample(n, 1, random)
        return (self.l + x * self.diam).astype(_DTYPE)

    def uniform_boundary_points(self, n: int) -> np.ndarray:
        if n == 1:
            return np.array([[self.l]], dtype=_DTYPE)
        xl = np.full((n // 2, 1), self.l, dtype=_DTYPE)
        xr = np.full((n - n // 2, 1), self.r, dtype=_DTYPE)
        return np.concatenate([xl, xr], axis=0)

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        if n == 2:
            return np.array([[self.l], [self.r]], dtype=_DTYPE)
        return np.random.choice([self.l, self.r], n).reshape(-1, 1).astype(_DTYPE)

    def periodic_point(self, x, component: int = 0):
        y = geometry.convert_to_array(x, self.dim_keys).copy()
        on_l = np.isclose(y[:, 0], self.l)
        on_r = np.isclose(y[:, 0], self.r)
        y[on_l, 0] = self.r
        y[on_r, 0] = self.l
        y_normal = self.boundary_normal(y)
        return {
            **geometry.convert_to_dict(y, self.dim_keys),
            **geometry.convert_to_dict(y_normal, [f"normal_{k}" for k in self.dim_keys]),
        }

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        """Negative inside: max(l - x, x - r)."""
        return np.maximum(self.l - points, points - self.r)
