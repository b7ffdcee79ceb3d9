"""N-D geometry: Hypercube, Hypersphere (counterpart of
``paddlescience_tpu/geometry/geometry_nd.py``, a numpy copy)."""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from paddlescience_torch.geometry import geometry, sampler

__all__ = ["Hypercube", "Hypersphere"]

_DTYPE = np.float32


class Hypercube(geometry.Geometry):
    """Axis-aligned box [xmin, xmax]^d."""

    def __init__(self, xmin: Tuple[float, ...], xmax: Tuple[float, ...]):
        if len(xmin) != len(xmax):
            raise ValueError("Dimensions of xmin and xmax do not match.")
        self.xmin = np.array(xmin, dtype=_DTYPE)
        self.xmax = np.array(xmax, dtype=_DTYPE)
        if np.any(self.xmin >= self.xmax):
            raise ValueError("xmin >= xmax")
        self.side_lengths = self.xmax - self.xmin
        self.volume = float(np.prod(self.side_lengths))
        super().__init__(
            len(xmin),
            (self.xmin[None, :], self.xmax[None, :]),
            float(np.linalg.norm(self.side_lengths)),
        )

    def is_inside(self, x: np.ndarray) -> np.ndarray:
        return np.logical_and(np.all(x >= self.xmin, axis=-1), np.all(x <= self.xmax, axis=-1))

    def on_boundary(self, x: np.ndarray) -> np.ndarray:
        _on = np.any(np.isclose(x, self.xmin) | np.isclose(x, self.xmax), axis=-1)
        return np.logical_and(self.is_inside(x), _on)

    def boundary_normal(self, x: np.ndarray) -> np.ndarray:
        _n = (-1.0 * np.isclose(x, self.xmin) + 1.0 * np.isclose(x, self.xmax)).astype(_DTYPE)
        # normalize corner points so |n| = 1
        norm = np.linalg.norm(_n, axis=-1, keepdims=True)
        norm[norm == 0] = 1.0
        return _n / norm

    def uniform_points(self, n: int, boundary: bool = True) -> np.ndarray:
        dx = (self.volume / n) ** (1 / self.ndim)
        xi = []
        for i in range(self.ndim):
            ni = int(np.ceil(self.side_lengths[i] / dx))
            if boundary:
                xi.append(np.linspace(self.xmin[i], self.xmax[i], ni, dtype=_DTYPE))
            else:
                xi.append(np.linspace(self.xmin[i], self.xmax[i], ni + 1, endpoint=False, dtype=_DTYPE)[1:])
        x = np.array(list(itertools.product(*xi)), dtype=_DTYPE)
        if len(x) > n:
            x = x[:n]
        return x

    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        x = sampler.sample(n, self.ndim, random)
        return (self.side_lengths * x + self.xmin).astype(_DTYPE)

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        x = sampler.sample(n, self.ndim, random)
        # snap a uniformly-chosen dimension per point to its nearest face
        rand_dim = np.random.randint(self.ndim, size=n)
        x[np.arange(n), rand_dim] = np.round(x[np.arange(n), rand_dim])
        return (self.side_lengths * x + self.xmin).astype(_DTYPE)

    def periodic_point(self, x, component: int):
        y = geometry.convert_to_array(x, self.dim_keys).copy()
        _on_xmin = np.isclose(y[:, component], self.xmin[component])
        _on_xmax = np.isclose(y[:, component], self.xmax[component])
        y[:, component][_on_xmin] = self.xmax[component]
        y[:, component][_on_xmax] = self.xmin[component]
        y_normal = self.boundary_normal(y)
        return {
            **geometry.convert_to_dict(y, self.dim_keys),
            **geometry.convert_to_dict(y_normal, [f"normal_{k}" for k in self.dim_keys]),
        }

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        """Exact box SDF (negative inside), (N, 1)."""
        center = (self.xmin + self.xmax) / 2
        half = self.side_lengths / 2
        q = np.abs(points - center) - half
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(np.max(q, axis=-1), 0.0)
        return (outside + inside).reshape(-1, 1)


class Hypersphere(geometry.Geometry):
    """Ball {|x - c| <= r}."""

    def __init__(self, center: Tuple[float, ...], radius: float):
        self.center = np.array(center, dtype=_DTYPE)
        self.radius = float(radius)
        super().__init__(
            len(center),
            (self.center[None, :] - radius, self.center[None, :] + radius),
            2 * radius,
        )
        self._r2 = radius**2

    def is_inside(self, x: np.ndarray) -> np.ndarray:
        return np.linalg.norm(x - self.center, axis=-1) <= self.radius

    def on_boundary(self, x: np.ndarray) -> np.ndarray:
        return np.isclose(np.linalg.norm(x - self.center, axis=-1), self.radius)

    def boundary_normal(self, x: np.ndarray) -> np.ndarray:
        _n = x - self.center
        norm = np.linalg.norm(_n, axis=-1, keepdims=True)
        norm[norm == 0] = 1.0
        return (_n / norm).astype(_DTYPE)

    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        """Muller-Marsaglia ball sampling: direction ~ N(0,I) normalized,
        radius ~ U^(1/d)."""
        if random == "pseudo":
            u = np.random.random((n, 1))
            g = np.random.normal(size=(n, self.ndim))
        else:
            from scipy import stats  # here, not at import: scipy.stats takes seconds to load

            s = sampler.sample(n, self.ndim + 1, random)
            u, g = s[:, 0:1], stats.norm.ppf(s[:, 1:])
        g /= np.linalg.norm(g, axis=-1, keepdims=True)
        x = u ** (1 / self.ndim) * g
        return (self.radius * x + self.center).astype(_DTYPE)

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        if random == "pseudo":
            g = np.random.normal(size=(n, self.ndim))
        else:
            from scipy import stats

            u = sampler.sample(n, self.ndim, random)
            g = stats.norm.ppf(u)
        g /= np.linalg.norm(g, axis=-1, keepdims=True)
        return (self.radius * g + self.center).astype(_DTYPE)

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        return (np.linalg.norm(points - self.center, axis=-1) - self.radius).reshape(-1, 1)
