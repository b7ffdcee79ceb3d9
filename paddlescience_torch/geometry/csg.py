"""Constructive solid geometry: union, difference, intersection
(counterpart of ``paddlescience_tpu/geometry/csg.py``, a numpy copy)."""

from __future__ import annotations

import numpy as np

from paddlescience_torch.geometry import geometry

__all__ = ["CSGUnion", "CSGDifference", "CSGIntersection"]

_DTYPE = np.float32


def _rejection_fill(n, ndim, gen, max_try=10000, what="points"):
    x = np.empty((n, ndim), dtype=_DTYPE)
    _size, _ntry, _nsuc = 0, 0, 0
    while _size < n:
        points = gen(n)
        if len(points) > n - _size:
            points = points[: n - _size]
        x[_size : _size + len(points)] = points
        _size += len(points)
        _ntry += 1
        if len(points) > 0:
            _nsuc = 1
        if _ntry >= max_try and _nsuc == 0:
            raise ValueError(f"CSG sampling of {what} failed; check geometry validity")
    return x


class CSGUnion(geometry.Geometry):
    """A | B."""

    def __init__(self, geom1: geometry.Geometry, geom2: geometry.Geometry):
        if geom1.ndim != geom2.ndim:
            raise ValueError(f"{geom1}: {geom1.ndim} != {geom2}: {geom2.ndim}")
        super().__init__(
            geom1.ndim,
            (np.minimum(geom1.bbox[0], geom2.bbox[0]), np.maximum(geom1.bbox[1], geom2.bbox[1])),
            geom1.diam + geom2.diam,
        )
        self.geom1 = geom1
        self.geom2 = geom2

    def is_inside(self, x):
        return np.logical_or(self.geom1.is_inside(x), self.geom2.is_inside(x))

    def on_boundary(self, x):
        return np.logical_or(
            np.logical_and(self.geom1.on_boundary(x), ~self.geom2.is_inside(x)),
            np.logical_and(self.geom2.on_boundary(x), ~self.geom1.is_inside(x)),
        )

    def boundary_normal(self, x):
        g1 = np.logical_and(self.geom1.on_boundary(x), ~self.geom2.is_inside(x))
        g2 = np.logical_and(self.geom2.on_boundary(x), ~self.geom1.is_inside(x))
        n = np.zeros((len(x), self.ndim), dtype=_DTYPE)
        if g1.any():
            n[g1] = self.geom1.boundary_normal(x[g1])
        if g2.any():
            n[g2] = self.geom2.boundary_normal(x[g2])
        return n

    def random_points(self, n, random="pseudo"):
        def gen(k):
            pts = (np.random.rand(k, self.ndim) * (self.bbox[1] - self.bbox[0]) + self.bbox[0]).astype(_DTYPE)
            return pts[self.is_inside(pts)]

        return _rejection_fill(n, self.ndim, gen, 1000, "interior")

    def random_boundary_points(self, n, random="pseudo"):
        def gen(k):
            p1 = self.geom1.random_boundary_points(k, random=random)
            p1 = p1[~self.geom2.is_inside(p1)]
            p2 = self.geom2.random_boundary_points(k, random=random)
            p2 = p2[~self.geom1.is_inside(p2)]
            return np.random.permutation(np.concatenate((p1, p2)))

        return _rejection_fill(n, self.ndim, gen, 10000, "boundary")

    def periodic_point(self, x, component):
        raise NotImplementedError("periodic_point is ambiguous on CSG geometry")

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        """min(sdf1, sdf2) — exact only away from intersections (standard CSG bound)."""
        return np.minimum(self.geom1.sdf_func(points), self.geom2.sdf_func(points))


class CSGDifference(geometry.Geometry):
    """A \\ B."""

    def __init__(self, geom1: geometry.Geometry, geom2: geometry.Geometry):
        if geom1.ndim != geom2.ndim:
            raise ValueError(f"{geom1}: {geom1.ndim} != {geom2}: {geom2.ndim}")
        super().__init__(geom1.ndim, geom1.bbox, geom1.diam)
        self.geom1 = geom1
        self.geom2 = geom2

    def is_inside(self, x):
        return np.logical_and(self.geom1.is_inside(x), ~self.geom2.is_inside(x))

    def on_boundary(self, x):
        return np.logical_or(
            np.logical_and(self.geom1.on_boundary(x), ~self.geom2.is_inside(x)),
            np.logical_and(self.geom1.is_inside(x), self.geom2.on_boundary(x)),
        )

    def boundary_normal(self, x):
        g1 = np.logical_and(self.geom1.on_boundary(x), ~self.geom2.is_inside(x))
        g2 = np.logical_and(self.geom1.is_inside(x), self.geom2.on_boundary(x))
        n = np.zeros((len(x), self.ndim), dtype=_DTYPE)
        if g1.any():
            n[g1] = self.geom1.boundary_normal(x[g1])
        if g2.any():
            n[g2] = -self.geom2.boundary_normal(x[g2])  # carved surface points inward of B
        return n

    def random_points(self, n, random="pseudo"):
        def gen(k):
            pts = self.geom1.random_points(k, random=random)
            return pts[~self.geom2.is_inside(pts)]

        return _rejection_fill(n, self.ndim, gen, 1000, "interior")

    def random_boundary_points(self, n, random="pseudo"):
        def gen(k):
            p1 = self.geom1.random_boundary_points(k, random=random)
            p1 = p1[~self.geom2.is_inside(p1)]
            p2 = self.geom2.random_boundary_points(k, random=random)
            p2 = p2[self.geom1.is_inside(p2)]
            return np.random.permutation(np.concatenate((p1, p2)))

        return _rejection_fill(n, self.ndim, gen, 10000, "boundary")

    def periodic_point(self, x, component):
        raise NotImplementedError("periodic_point is ambiguous on CSG geometry")

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        return np.maximum(self.geom1.sdf_func(points), -self.geom2.sdf_func(points))


class CSGIntersection(geometry.Geometry):
    """A & B."""

    def __init__(self, geom1: geometry.Geometry, geom2: geometry.Geometry):
        if geom1.ndim != geom2.ndim:
            raise ValueError(f"{geom1}: {geom1.ndim} != {geom2}: {geom2.ndim}")
        super().__init__(
            geom1.ndim,
            (np.maximum(geom1.bbox[0], geom2.bbox[0]), np.minimum(geom1.bbox[1], geom2.bbox[1])),
            min(geom1.diam, geom2.diam),
        )
        self.geom1 = geom1
        self.geom2 = geom2

    def is_inside(self, x):
        return np.logical_and(self.geom1.is_inside(x), self.geom2.is_inside(x))

    def on_boundary(self, x):
        return np.logical_or(
            np.logical_and(self.geom1.on_boundary(x), self.geom2.is_inside(x)),
            np.logical_and(self.geom1.is_inside(x), self.geom2.on_boundary(x)),
        )

    def boundary_normal(self, x):
        g1 = np.logical_and(self.geom1.on_boundary(x), self.geom2.is_inside(x))
        g2 = np.logical_and(self.geom1.is_inside(x), self.geom2.on_boundary(x))
        n = np.zeros((len(x), self.ndim), dtype=_DTYPE)
        if g1.any():
            n[g1] = self.geom1.boundary_normal(x[g1])
        if g2.any():
            n[g2] = self.geom2.boundary_normal(x[g2])
        return n

    def random_points(self, n, random="pseudo"):
        def gen(k):
            pts = self.geom1.random_points(k, random=random)
            return pts[self.geom2.is_inside(pts)]

        return _rejection_fill(n, self.ndim, gen, 1000, "interior")

    def random_boundary_points(self, n, random="pseudo"):
        def gen(k):
            p1 = self.geom1.random_boundary_points(k, random=random)
            p1 = p1[self.geom2.is_inside(p1)]
            p2 = self.geom2.random_boundary_points(k, random=random)
            p2 = p2[self.geom1.is_inside(p2)]
            return np.random.permutation(np.concatenate((p1, p2)))

        return _rejection_fill(n, self.ndim, gen, 10000, "boundary")

    def periodic_point(self, x, component):
        raise NotImplementedError("periodic_point is ambiguous on CSG geometry")

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        return np.maximum(self.geom1.sdf_func(points), self.geom2.sdf_func(points))
