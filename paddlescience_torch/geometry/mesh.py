"""Triangle-mesh geometry read from STL (counterpart of
``paddlescience_tpu/geometry/mesh.py``; a near-copy in numpy).

Binary and ASCII STL parsing, ray casting for the inside test, exact
point-triangle distances for the SDF, and area-weighted barycentric surface
sampling that returns the per-point "area" column of integral-weighted
losses. The ray cast and the distances run in the port's C++ library
(``geometry/raycast.py``, built with g++ at first use; a failure raises),
or, with ``native=False``, in numpy (the plain version, the JAX package's
numpy branch). Both count the same hits, so they keep the same points.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple, Union

import numpy as np

from paddlescience_torch.geometry import geometry, raycast

__all__ = ["Mesh", "SDFMesh", "load_stl"]

_DTYPE = np.float32


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse STL (binary or ASCII) -> (vertices (V,3), faces (F,3))."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head.lower() == b"solid":
        # try ASCII; fall back to binary (some binary files start with 'solid')
        try:
            return _load_stl_ascii(path)
        except (ValueError, UnicodeDecodeError):
            pass
    return _load_stl_binary(path)


def _load_stl_binary(path: str):
    with open(path, "rb") as f:
        f.read(80)
        (n_tri,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
    rec = data.reshape(n_tri, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    verts = tri.reshape(-1, 3)
    uniq, inverse = np.unique(verts.round(6), axis=0, return_inverse=True)
    faces = inverse.reshape(n_tri, 3)
    return uniq.astype(_DTYPE), faces.astype(np.int64)


def _load_stl_ascii(path: str):
    verts = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line.startswith("vertex"):
                verts.append([float(v) for v in line.split()[1:4]])
    verts = np.asarray(verts, _DTYPE)
    if len(verts) == 0 or len(verts) % 3 != 0:
        raise ValueError("not a valid ASCII STL")
    n_tri = len(verts) // 3
    uniq, inverse = np.unique(verts.round(6), axis=0, return_inverse=True)
    return uniq.astype(_DTYPE), inverse.reshape(n_tri, 3).astype(np.int64)


class Mesh(geometry.Geometry):
    """Watertight triangle mesh geometry, from an STL path or explicit
    (vertices, faces) arrays. ``native`` chooses the C++ ray cast and
    distances (default) or their numpy versions."""

    def __init__(self, mesh: Union[str, Tuple[np.ndarray, np.ndarray]], name: Optional[str] = None,
                 native: bool = True):
        self.native = native
        if isinstance(mesh, str):
            vertices, faces = load_stl(mesh)
        else:
            vertices, faces = mesh
        self.vertices = np.asarray(vertices, _DTYPE)
        self.faces = np.asarray(faces, np.int64)
        self.v0 = self.vertices[self.faces[:, 0]]
        self.v1 = self.vertices[self.faces[:, 1]]
        self.v2 = self.vertices[self.faces[:, 2]]
        cross = np.cross(self.v1 - self.v0, self.v2 - self.v0)
        norms = np.linalg.norm(cross, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        self.face_normals = (cross / norms).astype(_DTYPE)
        self.face_areas = (norms[:, 0] / 2).astype(np.float64)
        self.area = float(self.face_areas.sum())
        xmin = self.vertices.min(axis=0, keepdims=True)
        xmax = self.vertices.max(axis=0, keepdims=True)
        super().__init__(3, (xmin, xmax), float(np.linalg.norm(xmax - xmin)))

    # -- inside test via ray casting (chunked) ---------------------------------
    def _ray_hits(self, points: np.ndarray, direction: np.ndarray) -> np.ndarray:
        """Count ray-triangle intersections per point along ``direction``.

        Rotates the frame so the ray is the +z axis; the test is then a 2-D
        barycentric point-in-triangle plus a depth comparison: per point in
        the C++ library, or in numpy on (P, F) temporaries chunked to about
        4e6 elements."""
        eps = 1e-12
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        u_ax = np.cross(d, a)
        u_ax /= np.linalg.norm(u_ax)
        v_ax = np.cross(d, u_ax)
        R = np.stack([u_ax, v_ax, d])  # (3, 3): rows are the new axes
        p_r = np.asarray(points, np.float64) @ R.T
        A = self.v0.astype(np.float64) @ R.T
        B = self.v1.astype(np.float64) @ R.T
        C = self.v2.astype(np.float64) @ R.T
        if self.native:
            return raycast.ray_hits_z(np.concatenate([A, B, C], axis=1), p_r)
        denom = (B[:, 1] - C[:, 1]) * (A[:, 0] - C[:, 0]) + (C[:, 0] - B[:, 0]) * (A[:, 1] - C[:, 1])
        ok = np.abs(denom) > eps
        inv = np.where(ok, 1.0 / np.where(ok, denom, 1.0), 0.0)
        counts = np.zeros(len(points), np.int64)
        chunk = max(int(4e6 // max(len(self.faces), 1)), 1)
        for lo in range(0, len(p_r), chunk):
            px = p_r[lo : lo + chunk, 0:1]  # (P, 1)
            py = p_r[lo : lo + chunk, 1:2]
            pz = p_r[lo : lo + chunk, 2:3]
            w1 = ((B[:, 1] - C[:, 1]) * (px - C[:, 0]) + (C[:, 0] - B[:, 0]) * (py - C[:, 1])) * inv
            w2 = ((C[:, 1] - A[:, 1]) * (px - C[:, 0]) + (A[:, 0] - C[:, 0]) * (py - C[:, 1])) * inv
            w3 = 1.0 - w1 - w2
            zhit = w1 * A[:, 2] + w2 * B[:, 2] + w3 * C[:, 2]
            hit = ok & (w1 >= -1e-9) & (w2 >= -1e-9) & (w3 >= -1e-9) & (zhit > pz + 1e-9)
            counts[lo : lo + chunk] = hit.sum(axis=1)
        return counts

    def is_inside(self, x: np.ndarray) -> np.ndarray:
        # odd intersection count = inside; a random direction avoids edge cases
        rng = np.random.default_rng(0)
        d = rng.normal(size=3)
        return (self._ray_hits(np.asarray(x, np.float64), d) % 2) == 1

    def on_boundary(self, x: np.ndarray) -> np.ndarray:
        return np.abs(self.sdf_func(x).flatten()) < 1e-6 * self.diam

    # -- sampling ----------------------------------------------------------------
    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        out = np.empty((n, 3), _DTYPE)
        size = 0
        lo = np.asarray(self.bbox[0], np.float64)
        hi = np.asarray(self.bbox[1], np.float64)
        tries = 0
        while size < n:
            cand = np.random.uniform(size=(max(n, 256), 3)) * (hi - lo) + lo
            cand = cand[self.is_inside(cand)]
            take = min(len(cand), n - size)
            out[size : size + take] = cand[:take]
            size += take
            tries += 1
            if tries > 1000 and size == 0:
                raise ValueError("mesh interior sampling failed; is the mesh watertight?")
        return out

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        pts, _, _ = self._sample_surface(n)
        return pts

    def _sample_surface(self, n: int):
        probs = self.face_areas / self.face_areas.sum()
        idx = np.random.choice(len(self.faces), size=n, p=probs)
        r1 = np.sqrt(np.random.rand(n, 1))
        r2 = np.random.rand(n, 1)
        pts = (1 - r1) * self.v0[idx] + r1 * (1 - r2) * self.v1[idx] + r1 * r2 * self.v2[idx]
        normals = self.face_normals[idx]
        areas = np.full((n, 1), self.area / n, _DTYPE)
        return pts.astype(_DTYPE), normals.astype(_DTYPE), areas

    def sample_boundary(self, n, random="pseudo", criteria=None, evenly=False):
        """Boundary sample with normals and per-point Monte-Carlo area
        weights ("area" = mesh area / n)."""
        collected_p, collected_n = [], []
        total = 0
        tries = 0
        while total < n:
            pts, normals, _ = self._sample_surface(n)
            if criteria is not None:
                mask = criteria(*np.split(pts, 3, axis=1)).flatten()
                pts, normals = pts[mask], normals[mask]
            collected_p.append(pts)
            collected_n.append(normals)
            total += len(pts)
            tries += 1
            if tries > 10000 and total == 0:
                raise ValueError("mesh boundary sampling failed under criteria")
        pts = np.concatenate(collected_p)[:n]
        normals = np.concatenate(collected_n)[:n]
        areas = np.full((n, 1), self.area / n, _DTYPE)
        x_dict = geometry.convert_to_dict(pts, self.dim_keys)
        normal_dict = geometry.convert_to_dict(normals, [f"normal_{k}" for k in self.dim_keys])
        return {**x_dict, **normal_dict, "area": areas}

    # -- SDF -----------------------------------------------------------------------
    def _unsigned_distance(self, points: np.ndarray) -> np.ndarray:
        """Exact min point-triangle distance: per point in the C++ library,
        or in numpy chunked over points, the expansion of |v0 + s e1 + t e2
        - p|^2 as (P, F) matrix products."""
        p = np.asarray(points, np.float64)
        if self.native:
            return raycast.unsigned_distance(np.concatenate([self.v0, self.v1, self.v2], axis=1), p)
        e1 = (self.v1 - self.v0).astype(np.float64)
        e2 = (self.v2 - self.v0).astype(np.float64)
        a = np.einsum("fj,fj->f", e1, e1)
        b = np.einsum("fj,fj->f", e1, e2)
        c = np.einsum("fj,fj->f", e2, e2)
        det = a * c - b * b
        det = np.where(det <= 0, 1e-30, det)
        v0 = self.v0.astype(np.float64)
        v0e1 = np.einsum("fj,fj->f", v0, e1)
        v0e2 = np.einsum("fj,fj->f", v0, e2)
        v0v0 = np.einsum("fj,fj->f", v0, v0)
        out = np.empty(len(p))
        chunk = max(int(4e6 // max(len(self.faces), 1)), 1)
        for lo in range(0, len(p), chunk):
            pp = p[lo : lo + chunk]  # (P, 3)
            pe1 = pp @ e1.T  # (P, F)
            pe2 = pp @ e2.T
            pv0 = pp @ v0.T
            d_ = v0e1[None] - pe1  # dvec . e1 with dvec = v0 - p
            e_ = v0e2[None] - pe2
            s = np.clip((b * e_ - c * d_) / det, 0, 1)
            t = np.clip((b * d_ - a * e_) / det, 0, 1)
            over = s + t > 1
            if over.any():
                total = (s + t)[over]
                s[over] /= total
                t[over] /= total
            dd = v0v0[None] - 2 * pv0 + np.einsum("pj,pj->p", pp, pp)[:, None]
            dist2 = dd + 2 * s * d_ + 2 * t * e_ + s * s * a + 2 * s * t * b + t * t * c
            out[lo : lo + chunk] = np.sqrt(np.maximum(dist2.min(axis=1), 0.0))
        return out

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        """Negative inside (the framework convention)."""
        d = self._unsigned_distance(points)
        sign = np.where(self.is_inside(points), -1.0, 1.0)
        return (sign * d).reshape(-1, 1)

    def translate(self, translation) -> "Mesh":
        return Mesh((self.vertices + np.asarray(translation, _DTYPE), self.faces), native=self.native)

    def scale(self, scale: float) -> "Mesh":
        return Mesh((self.vertices * scale, self.faces), native=self.native)

    def __str__(self):
        return ", ".join([
            self.__class__.__name__,
            f"num_vertices = {len(self.vertices)}",
            f"num_faces = {len(self.faces)}",
            f"bbox = {self.bbox}",
        ])


class SDFMesh(Mesh):
    """An STL mesh whose inside test and signed distance come from the ray
    cast alone, as the JAX package's ``SDFMesh``: the same math as
    :class:`Mesh`, a class of its own so configurations that name it
    build. The time-space product and the geometry checks that look for a
    mesh by its type name accept both."""

    @classmethod
    def from_stl(cls, path: str) -> "SDFMesh":
        return cls(path)
