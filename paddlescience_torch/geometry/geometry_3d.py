"""3-D geometry: Cuboid, Sphere (counterpart of
``paddlescience_tpu/geometry/geometry_3d.py``, a numpy copy)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from paddlescience_torch.geometry import geometry_2d, geometry_nd

__all__ = ["Cuboid", "Sphere"]

_DTYPE = np.float32


class Cuboid(geometry_nd.Hypercube):
    """Axis-aligned box in 3-D with area-weighted face sampling."""

    def __init__(self, xmin: Tuple[float, float, float], xmax: Tuple[float, float, float]):
        super().__init__(xmin, xmax)
        dx, dy, dz = self.side_lengths
        self.area = 2 * float(dx * dy + dy * dz + dx * dz)

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        """Sample each face pair at density n/area."""
        pts = []
        density = n / self.area
        rect = geometry_2d.Rectangle(self.xmin[:-1], self.xmax[:-1])
        for z in [self.xmin[-1], self.xmax[-1]]:
            u = rect.random_points(int(np.ceil(density * rect.area)), random=random)
            pts.append(np.hstack((u, np.full((len(u), 1), z, dtype=_DTYPE))))
        rect = geometry_2d.Rectangle(self.xmin[::2], self.xmax[::2])
        for y in [self.xmin[1], self.xmax[1]]:
            u = rect.random_points(int(np.ceil(density * rect.area)), random=random)
            pts.append(np.hstack((u[:, 0:1], np.full((len(u), 1), y, dtype=_DTYPE), u[:, 1:])))
        rect = geometry_2d.Rectangle(self.xmin[1:], self.xmax[1:])
        for x in [self.xmin[0], self.xmax[0]]:
            u = rect.random_points(int(np.ceil(density * rect.area)), random=random)
            pts.append(np.hstack((np.full((len(u), 1), x, dtype=_DTYPE), u)))
        pts = np.vstack(pts).astype(_DTYPE)
        if len(pts) > n:
            return pts[np.random.choice(len(pts), size=n, replace=False)]
        return pts

    def uniform_boundary_points(self, n: int) -> np.ndarray:
        """Grid points on each face at density ~ n/area."""
        density = n / self.area
        pts = []
        axes = [(0, 1, 2), (0, 2, 1), (1, 2, 0)]
        for a, b, fixed in axes:
            la = float(self.side_lengths[a])
            lb = float(self.side_lengths[b])
            na = max(int(np.ceil(np.sqrt(density * la * lb) * la / max(lb, 1e-12))), 2)
            nb = max(int(np.ceil(density * la * lb / na)), 2)
            ua = np.linspace(self.xmin[a], self.xmax[a], na, dtype=_DTYPE)
            ub = np.linspace(self.xmin[b], self.xmax[b], nb, dtype=_DTYPE)
            A, B = np.meshgrid(ua, ub, indexing="ij")
            for val in [self.xmin[fixed], self.xmax[fixed]]:
                face = np.empty((na * nb, 3), dtype=_DTYPE)
                face[:, a] = A.ravel()
                face[:, b] = B.ravel()
                face[:, fixed] = val
                pts.append(face)
        pts = np.vstack(pts)
        if len(pts) > n:
            pts = pts[np.random.choice(len(pts), size=n, replace=False)]
        return pts


class Sphere(geometry_nd.Hypersphere):
    """Ball in 3-D with Fibonacci-lattice
    uniform boundary points."""

    def __init__(self, center: Tuple[float, float, float], radius: float):
        super().__init__(center, radius)

    def uniform_boundary_points(self, n: int) -> np.ndarray:
        golden = (1 + 5**0.5) / 2
        i = np.arange(n)
        phi = np.arccos(1 - 2 * (i + 0.5) / n)
        theta = 2 * np.pi * i / golden
        xyz = np.stack(
            [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], axis=-1
        )
        return (self.radius * xyz + self.center).astype(_DTYPE)
