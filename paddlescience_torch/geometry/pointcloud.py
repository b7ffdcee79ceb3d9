"""Point-cloud geometry (counterpart of
``paddlescience_tpu/geometry/pointcloud.py``, a numpy copy)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from paddlescience_torch.geometry import geometry

__all__ = ["PointCloud"]

_DTYPE = np.float32


class PointCloud(geometry.Geometry):
    """Geometry defined by explicit interior points (and optionally boundary
    points + normals) loaded from arrays/files."""

    def __init__(
        self,
        interior: Dict[str, np.ndarray],
        coord_keys: Tuple[str, ...],
        boundary: Optional[Dict[str, np.ndarray]] = None,
        boundary_normal: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.interior = geometry.convert_to_array(interior, coord_keys).astype(_DTYPE)
        self.coord_keys = tuple(coord_keys)
        self.boundary = (
            geometry.convert_to_array(boundary, coord_keys).astype(_DTYPE) if boundary else None
        )
        self.normal = (
            geometry.convert_to_array(
                boundary_normal, tuple(f"normal_{k}" for k in coord_keys)
            ).astype(_DTYPE)
            if boundary_normal
            else None
        )
        xmin = np.min(self.interior, axis=0, keepdims=True)
        xmax = np.max(self.interior, axis=0, keepdims=True)
        super().__init__(len(coord_keys), (xmin, xmax), float(np.linalg.norm(xmax - xmin)))

    @property
    def dim_keys(self):
        return self.coord_keys

    def is_inside(self, x):
        return (
            np.isclose(x[:, None, :], self.interior[None, :, :]).all(axis=2).any(axis=1)
        )

    def on_boundary(self, x):
        if self.boundary is None:
            raise ValueError("boundary points not provided to PointCloud")
        return np.isclose(x[:, None, :], self.boundary[None, :, :]).all(axis=2).any(axis=1)

    def boundary_normal(self, x):
        if self.normal is None:
            raise ValueError("boundary normals not provided to PointCloud")
        # nearest stored boundary point's normal
        idx = np.argmin(np.linalg.norm(x[:, None, :] - self.boundary[None, :, :], axis=2), axis=1)
        return self.normal[idx]

    def translate(self, translation: np.ndarray) -> "PointCloud":
        self.interior = self.interior + translation
        if self.boundary is not None:
            self.boundary = self.boundary + translation
        return self

    def scale(self, scale: np.ndarray) -> "PointCloud":
        self.interior = self.interior * scale
        if self.boundary is not None:
            self.boundary = self.boundary * scale
        if self.normal is not None:
            n = self.normal * scale
            self.normal = n / np.linalg.norm(n, axis=1, keepdims=True)
        return self

    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        """Cycle a random permutation of stored points."""
        reps = int(np.ceil(n / len(self.interior)))
        chunks = [np.random.permutation(self.interior) for _ in range(reps)]
        return np.concatenate(chunks, axis=0)[:n]

    def uniform_points(self, n: int, boundary: bool = True) -> np.ndarray:
        return self.interior[:n]

    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        if self.boundary is None:
            raise ValueError("boundary points not provided to PointCloud")
        reps = int(np.ceil(n / len(self.boundary)))
        chunks = [np.random.permutation(self.boundary) for _ in range(reps)]
        return np.concatenate(chunks, axis=0)[:n]

    def union(self, other):
        raise NotImplementedError("CSG on PointCloud is not supported")

    __or__ = union

    def difference(self, other):
        raise NotImplementedError("CSG on PointCloud is not supported")

    __sub__ = difference

    def intersection(self, other):
        raise NotImplementedError("CSG on PointCloud is not supported")

    __and__ = intersection

    def __str__(self):
        return ", ".join(
            [
                self.__class__.__name__,
                f"num_points = {len(self.interior)}",
                f"ndim = {self.ndim}",
                f"bbox = {self.bbox}",
                f"dim_keys = {self.dim_keys}",
            ]
        )
