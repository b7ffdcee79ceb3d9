"""2-D geometry: Disk, Rectangle, Triangle, Polygon (counterpart of
``paddlescience_tpu/geometry/geometry_2d.py``, a numpy copy)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from paddlescience_torch.geometry import geometry, geometry_nd, sampler

__all__ = ["Disk", "Rectangle", "Triangle", "Polygon", "polygon_signed_area"]

_DTYPE = np.float32


class Disk(geometry.Geometry):
    """Disk {|x - c| <= r} in 2-D."""

    def __init__(self, center: Tuple[float, float], radius: float):
        self.center = np.array(center, dtype=_DTYPE)
        self.radius = float(radius)
        super().__init__(2, (self.center[None, :] - radius, self.center[None, :] + radius), 2 * radius)

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
        s = sampler.sample(n, 2, random)
        r = self.radius * np.sqrt(s[:, 0:1])
        theta = 2 * np.pi * s[:, 1:2]
        return (np.concatenate([r * np.cos(theta), r * np.sin(theta)], axis=-1) + self.center).astype(_DTYPE)

    def uniform_boundary_points(self, n: int) -> np.ndarray:
        theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
        return (
            self.radius * np.stack([np.cos(theta), np.sin(theta)], axis=-1) + self.center
        ).astype(_DTYPE)

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        theta = 2 * np.pi * sampler.sample(n, 1, random)[:, 0]
        return (
            self.radius * np.stack([np.cos(theta), np.sin(theta)], axis=-1) + self.center
        ).astype(_DTYPE)

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        return (np.linalg.norm(points - self.center, axis=-1) - self.radius).reshape(-1, 1)


class Rectangle(geometry_nd.Hypercube):
    """Axis-aligned rectangle.

    Examples:
        >>> import paddlescience_torch as psci
        >>> geom = psci.geometry.Rectangle((0.0, 0.0), (1.0, 1.0))
        >>> pts = geom.sample_interior(8)
        >>> sorted(pts)
        ['sdf', 'x', 'y']
        >>> pts["x"].shape
        (8, 1)
    """

    def __init__(self, xmin: Tuple[float, float], xmax: Tuple[float, float]):
        super().__init__(xmin, xmax)
        self.perimeter = 2 * float(np.sum(self.xmax - self.xmin))
        self.area = float(np.prod(self.xmax - self.xmin))

    def uniform_boundary_points(self, n: int) -> np.ndarray:
        """Walk the perimeter with ~n equispaced points."""
        lx, ly = self.side_lengths
        nx = max(int(np.ceil(n * lx / self.perimeter)), 1)
        ny = max(int(np.ceil(n * ly / self.perimeter)), 1)
        xmin, ymin = self.xmin
        xmax, ymax = self.xmax
        bottom = np.stack(
            [np.linspace(xmin, xmax, nx, endpoint=False), np.full(nx, ymin)], axis=-1
        )
        right = np.stack(
            [np.full(ny, xmax), np.linspace(ymin, ymax, ny, endpoint=False)], axis=-1
        )
        top = np.stack(
            [np.linspace(xmax, xmin, nx, endpoint=False), np.full(nx, ymax)], axis=-1
        )
        left = np.stack(
            [np.full(ny, xmin), np.linspace(ymax, ymin, ny, endpoint=False)], axis=-1
        )
        pts = np.concatenate([bottom, right, top, left], axis=0).astype(_DTYPE)
        if len(pts) > n:
            pts = pts[np.random.choice(len(pts), size=n, replace=False)]
        return pts

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        """Arc-length parameterized: u ~ U[0, perimeter) mapped onto edges."""
        lx, ly = float(self.side_lengths[0]), float(self.side_lengths[1])
        u = self.perimeter * sampler.sample(n, 1, random)[:, 0]
        pts = np.empty((n, 2), dtype=_DTYPE)
        xmin, ymin = self.xmin
        # bottom edge
        m = u < lx
        pts[m] = np.stack([xmin + u[m], np.full(m.sum(), ymin)], axis=-1)
        # right edge
        m = (u >= lx) & (u < lx + ly)
        pts[m] = np.stack([np.full(m.sum(), xmin + lx), ymin + (u[m] - lx)], axis=-1)
        # top edge
        m = (u >= lx + ly) & (u < 2 * lx + ly)
        pts[m] = np.stack([xmin + lx - (u[m] - lx - ly), np.full(m.sum(), ymin + ly)], axis=-1)
        # left edge
        m = u >= 2 * lx + ly
        pts[m] = np.stack([np.full(m.sum(), xmin), ymin + ly - (u[m] - 2 * lx - ly)], axis=-1)
        return pts

    @staticmethod
    def is_valid(vertices: np.ndarray) -> bool:
        return (
            len(vertices) == 4
            and np.isclose(np.prod(vertices[1] - vertices[0]), 0)
            and np.isclose(np.prod(vertices[2] - vertices[1]), 0)
            and np.isclose(np.prod(vertices[3] - vertices[2]), 0)
            and np.isclose(np.prod(vertices[0] - vertices[3]), 0)
        )


class Triangle(geometry.Geometry):
    """Triangle given by three vertices."""

    def __init__(self, x1, x2, x3):
        self.x1 = np.array(x1, dtype=_DTYPE)
        self.x2 = np.array(x2, dtype=_DTYPE)
        self.x3 = np.array(x3, dtype=_DTYPE)
        self.v12 = self.x2 - self.x1
        self.v23 = self.x3 - self.x2
        self.v31 = self.x1 - self.x3
        self.l12 = float(np.linalg.norm(self.v12))
        self.l23 = float(np.linalg.norm(self.v23))
        self.l31 = float(np.linalg.norm(self.v31))
        self.n12 = self.v12 / self.l12
        self.n23 = self.v23 / self.l23
        self.n31 = self.v31 / self.l31
        self.n12_normal = clockwise_rotation_90(self.n12)
        self.n23_normal = clockwise_rotation_90(self.n23)
        self.n31_normal = clockwise_rotation_90(self.n31)
        self.perimeter = self.l12 + self.l23 + self.l31
        self.area = 0.5 * abs(float(_cross2(self.v12, -self.v31)))
        xmin = np.minimum(np.minimum(self.x1, self.x2), self.x3)
        xmax = np.maximum(np.maximum(self.x1, self.x2), self.x3)
        super().__init__(
            2,
            (xmin[None, :], xmax[None, :]),
            max(self.l12, self.l23, self.l31),
        )

    def is_inside(self, x: np.ndarray) -> np.ndarray:
        # consistent-sign cross products vs all edges
        c1 = _cross2(self.v12, x - self.x1)
        c2 = _cross2(self.v23, x - self.x2)
        c3 = _cross2(self.v31, x - self.x3)
        return ((c1 >= 0) & (c2 >= 0) & (c3 >= 0)) | ((c1 <= 0) & (c2 <= 0) & (c3 <= 0))

    def on_boundary(self, x: np.ndarray) -> np.ndarray:
        d = -self.sdf_func(x).flatten()
        return np.isclose(d, 0)

    def boundary_normal(self, x: np.ndarray) -> np.ndarray:
        def dist_to_seg(p, a, b):
            ab = b - a
            t = np.clip(((p - a) @ ab) / (ab @ ab), 0, 1)
            proj = a + t[:, None] * ab
            return np.linalg.norm(p - proj, axis=-1)

        d12 = dist_to_seg(x, self.x1, self.x2)
        d23 = dist_to_seg(x, self.x2, self.x3)
        d31 = dist_to_seg(x, self.x3, self.x1)
        choice = np.argmin(np.stack([d12, d23, d31], axis=-1), axis=-1)
        normals = np.stack([self.n12_normal, self.n23_normal, self.n31_normal], axis=0)
        n = normals[choice]
        # orient outward: flip if pointing towards the centroid
        centroid = (self.x1 + self.x2 + self.x3) / 3
        flip = np.sum(n * (centroid - x), axis=-1) > 0
        n[flip] *= -1
        return n.astype(_DTYPE)

    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        """Square-root barycentric trick: P = (1-sqrt(u)) A + sqrt(u)(1-v) B + sqrt(u) v C."""
        s = sampler.sample(n, 2, random)
        sqrt_r1 = np.sqrt(s[:, 0:1])
        r2 = s[:, 1:2]
        return (
            (1 - sqrt_r1) * self.x1 + sqrt_r1 * (1 - r2) * self.x2 + sqrt_r1 * r2 * self.x3
        ).astype(_DTYPE)

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        u = self.perimeter * sampler.sample(n, 1, random)[:, 0]
        pts = np.empty((n, 2), dtype=_DTYPE)
        m = u < self.l12
        pts[m] = self.x1 + (u[m] / self.l12)[:, None] * self.v12
        m = (u >= self.l12) & (u < self.l12 + self.l23)
        pts[m] = self.x2 + ((u[m] - self.l12) / self.l23)[:, None] * self.v23
        m = u >= self.l12 + self.l23
        pts[m] = self.x3 + ((u[m] - self.l12 - self.l23) / self.l31)[:, None] * self.v31
        return pts

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        """Signed distance: min distance to the three edges, negative inside."""

        def dist_to_seg(p, a, b):
            ab = b - a
            t = np.clip(((p - a) @ ab) / (ab @ ab), 0, 1)
            proj = a + t[:, None] * ab
            return np.linalg.norm(p - proj, axis=-1)

        d = np.minimum(
            np.minimum(dist_to_seg(points, self.x1, self.x2), dist_to_seg(points, self.x2, self.x3)),
            dist_to_seg(points, self.x3, self.x1),
        )
        sign = np.where(self.is_inside(points), -1.0, 1.0)
        return (sign * d).reshape(-1, 1)


class Polygon(geometry.Geometry):
    """Simple polygon via winding number."""

    def __init__(self, vertices):
        self.vertices = np.array(vertices, dtype=_DTYPE)
        if len(self.vertices) < 3:
            raise ValueError("polygon needs at least 3 vertices")
        if polygon_signed_area(self.vertices) < 0:
            self.vertices = np.flipud(self.vertices)  # enforce CCW
        self.nvert = len(self.vertices)
        self.edges = np.roll(self.vertices, -1, axis=0) - self.vertices
        self.edge_lengths = np.linalg.norm(self.edges, axis=-1)
        self.perimeter = float(np.sum(self.edge_lengths))
        self.area = abs(polygon_signed_area(self.vertices))
        xmin, xmax = np.min(self.vertices, axis=0), np.max(self.vertices, axis=0)
        super().__init__(2, (xmin[None, :], xmax[None, :]), float(np.linalg.norm(xmax - xmin)))

    def _winding_number(self, x: np.ndarray) -> np.ndarray:
        wn = np.zeros(len(x), dtype=np.int64)
        V = np.concatenate([self.vertices, self.vertices[:1]], axis=0)
        for i in range(self.nvert):
            a, b = V[i], V[i + 1]
            il = is_left(a, b, x)
            upward = (a[1] <= x[:, 1]) & (b[1] > x[:, 1]) & (il > 0)
            downward = (a[1] > x[:, 1]) & (b[1] <= x[:, 1]) & (il < 0)
            wn += upward.astype(np.int64) - downward.astype(np.int64)
        return wn

    def is_inside(self, x: np.ndarray) -> np.ndarray:
        return self._winding_number(x) != 0

    def on_boundary(self, x: np.ndarray) -> np.ndarray:
        return np.isclose(np.abs(self.sdf_func(x).flatten()), 0)

    def boundary_normal(self, x: np.ndarray) -> np.ndarray:
        # nearest edge's outward normal (CCW polygon: outward = CW rotation)
        dmin = np.full(len(x), np.inf)
        n = np.zeros_like(x)
        V = np.concatenate([self.vertices, self.vertices[:1]], axis=0)
        for i in range(self.nvert):
            a, b = V[i], V[i + 1]
            ab = b - a
            t = np.clip(((x - a) @ ab) / (ab @ ab), 0, 1)
            proj = a + t[:, None] * ab
            d = np.linalg.norm(x - proj, axis=-1)
            mask = d < dmin
            dmin[mask] = d[mask]
            edge_n = clockwise_rotation_90(ab / np.linalg.norm(ab))
            n[mask] = edge_n
        return n.astype(_DTYPE)

    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        x = np.empty((n, 2), dtype=_DTYPE)
        _size = 0
        while _size < n:
            cand = (
                sampler.sample(n, 2, random) * (self.bbox[1] - self.bbox[0]) + self.bbox[0]
            ).astype(_DTYPE)
            cand = cand[self.is_inside(cand)]
            if len(cand) > n - _size:
                cand = cand[: n - _size]
            x[_size : _size + len(cand)] = cand
            _size += len(cand)
        return x

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        cum = np.concatenate([[0.0], np.cumsum(self.edge_lengths)])
        u = self.perimeter * sampler.sample(n, 1, random)[:, 0]
        idx = np.searchsorted(cum, u, side="right") - 1
        idx = np.clip(idx, 0, self.nvert - 1)
        frac = (u - cum[idx]) / self.edge_lengths[idx]
        return (self.vertices[idx] + frac[:, None] * self.edges[idx]).astype(_DTYPE)

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        dmin = np.full(len(points), np.inf)
        V = np.concatenate([self.vertices, self.vertices[:1]], axis=0)
        for i in range(self.nvert):
            a, b = V[i], V[i + 1]
            ab = b - a
            t = np.clip(((points - a) @ ab) / (ab @ ab), 0, 1)
            proj = a + t[:, None] * ab
            d = np.linalg.norm(points - proj, axis=-1)
            dmin = np.minimum(dmin, d)
        sign = np.where(self.is_inside(points), -1.0, 1.0)
        return (sign * dmin).reshape(-1, 1)


def polygon_signed_area(vertices: np.ndarray) -> float:
    """Shoelace formula; positive for CCW."""
    x, y = vertices[:, 0], vertices[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _cross2(a, b):
    """z-component of the 2-D cross product (np.cross on 2-vectors is
    deprecated since NumPy 2.0)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def clockwise_rotation_90(v: np.ndarray) -> np.ndarray:
    """(x, y) -> (y, -x)."""
    return np.array([v[1], -v[0]], dtype=v.dtype)


def is_left(P0: np.ndarray, P1: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """>0 if P2 left of the line P0->P1."""
    return (P1[0] - P0[0]) * (P2[:, 1] - P0[1]) - (P2[:, 0] - P0[0]) * (P1[1] - P0[1])
