"""Geometry base class: host-side sampling, SDF and the CSG operators
(counterpart of ``paddlescience_tpu/geometry/geometry.py``).

All sampling is numpy on the host, once per constraint when it is built;
the solver moves the sampled arrays to the device once. The same
``np.random`` calls run in the same order as in the JAX package, so one
seed gives the same points in both, bitwise.

Conventions (identical to the JAX package):
  * ``sdf_func(x)`` is negative inside; ``sample_interior`` returns the
    flipped (positive-inside) value under key ``"sdf"``;
  * ``sample_interior`` -> {dim_keys..., "sdf"?, "sdf__x"?...};
    ``sample_boundary`` -> {dim_keys..., "normal_x"...} (no ``normal_t``
    on a time-space geometry, and "area" on a time-by-mesh boundary);
  * a ``TimeXGeometry`` takes the criteria into its own sampling (the
    spatial criteria see ``t = None``) before the rejection loop here
    applies them again to the whole (t, x, ...) points;
  * ``a | b``, ``a - b`` and ``a & b`` build the CSG union, difference and
    intersection (``geometry/csg.py``).
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Geometry", "convert_to_dict", "convert_to_array"]

_DTYPE = np.float32


def convert_to_dict(array: np.ndarray, keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """Split a concatenated (N, len(keys)) array into {key: (N, 1)} columns."""
    if array.shape[-1] != len(keys):
        raise ValueError(f"dim of array({array.shape[-1]}) must equal to len(keys)({len(keys)})")
    split = np.split(array, len(keys), axis=-1)
    return {key: split[i] for i, key in enumerate(keys)}


def convert_to_array(dict_: Mapping[str, np.ndarray], keys: Sequence[str]) -> np.ndarray:
    """Concatenate {key: (N, 1)} columns into (N, len(keys))."""
    return np.concatenate([dict_[key] for key in keys], axis=-1)


def _typename(obj) -> str:
    return type(obj).__name__


class Geometry(abc.ABC):
    """Base class for geometry."""

    def __init__(self, ndim: int, bbox: Tuple[np.ndarray, np.ndarray], diam: float):
        self.ndim = ndim
        self.bbox = bbox
        self.diam = min(diam, float(np.linalg.norm(bbox[1] - bbox[0])))

    @property
    def dim_keys(self):
        return ("x", "y", "z")[: self.ndim]

    @abc.abstractmethod
    def is_inside(self, x: np.ndarray) -> np.ndarray:
        """Boolean mask of points inside the (open) geometry."""

    @abc.abstractmethod
    def on_boundary(self, x: np.ndarray) -> np.ndarray:
        """Boolean mask of points on the boundary."""

    def boundary_normal(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError(f"{_typename(self)}.boundary_normal is not implemented")

    def uniform_points(self, n: int, boundary: bool = True) -> np.ndarray:
        """Equi-spaced interior points; random where not implemented."""
        return self.random_points(n)

    @abc.abstractmethod
    def random_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        """(n, ndim) random points inside the geometry."""

    @abc.abstractmethod
    def random_boundary_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        """(n, ndim) random points on the boundary."""

    def uniform_boundary_points(self, n: int) -> np.ndarray:
        return self.random_boundary_points(n)

    def periodic_point(self, x: np.ndarray, component: int):
        raise NotImplementedError(f"{_typename(self)}.periodic_point to be implemented")

    def sample_interior(
        self,
        n: int,
        random: str = "pseudo",
        criteria: Optional[Callable[..., np.ndarray]] = None,
        evenly: bool = False,
        compute_sdf_derivatives: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Rejection-sample n interior points meeting ``criteria``; returns
        coordinate columns plus positive-inside "sdf" (and "sdf__*" finite-
        difference derivatives if requested)."""
        x = np.empty(shape=(n, self.ndim), dtype=_DTYPE)
        _size, _ntry, _nsuc = 0, 0, 0
        while _size < n:
            if evenly:
                points = self.uniform_points(n)
            elif _typename(self) == "TimeXGeometry":
                points = self.random_points(n, random, criteria)
            else:
                points = self.random_points(n, random)
            if criteria is not None:
                criteria_mask = criteria(*np.split(points, self.ndim, axis=1)).flatten()
                points = points[criteria_mask]
            if len(points) > n - _size:
                points = points[: n - _size]
            x[_size : _size + len(points)] = points
            _size += len(points)
            _ntry += 1
            if len(points) > 0:
                _nsuc += 1
            if _ntry >= 1000 and _nsuc == 0:
                raise ValueError(
                    "Sample interior points failed, please check correctness of geometry and given criteria."
                )

        x_dict = convert_to_dict(x, self.dim_keys)
        sdf_dict, sdf_derives_dict = {}, {}
        if hasattr(self, "sdf_func"):
            sdf = -self.sdf_func(x)
            sdf_dict = convert_to_dict(sdf.astype(_DTYPE), ("sdf",))
            if compute_sdf_derivatives:
                sdf_derives = -self.sdf_derivatives(x)
                sdf_derives_dict = convert_to_dict(
                    sdf_derives.astype(_DTYPE), tuple(f"sdf__{key}" for key in self.dim_keys)
                )
        return {**x_dict, **sdf_dict, **sdf_derives_dict}

    def sample_boundary(
        self,
        n: int,
        random: str = "pseudo",
        criteria: Optional[Callable[..., np.ndarray]] = None,
        evenly: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Rejection-sample n boundary points; returns coordinates plus
        outward normals (and "area" on a time-by-mesh geometry, whose
        sampler returns aligned (points, normals, areas) of exactly n rows
        with the criteria applied inside)."""
        x = np.empty(shape=(n, self.ndim), dtype=_DTYPE)
        _size, _ntry, _nsuc = 0, 0, 0
        is_time = _typename(self) == "TimeXGeometry"
        is_mesh_time = is_time and _typename(getattr(self, "geometry", None)) in ("Mesh", "SDFMesh")
        normal = area = None
        if is_mesh_time:
            if evenly:
                x, normal, area = self.uniform_boundary_points(n)
            else:
                x, normal, area = self.random_boundary_points(n, random, criteria)
        else:
            while _size < n:
                if evenly:
                    points = self.uniform_boundary_points(n)
                elif is_time:
                    points = self.random_boundary_points(n, random, criteria)
                else:
                    points = self.random_boundary_points(n, random)
                if criteria is not None:
                    criteria_mask = criteria(*np.split(points, self.ndim, axis=1)).flatten()
                    points = points[criteria_mask]
                if len(points) > n - _size:
                    points = points[: n - _size]
                x[_size : _size + len(points)] = points
                _size += len(points)
                _ntry += 1
                if len(points) > 0:
                    _nsuc += 1
                if _ntry >= 10000 and _nsuc == 0:
                    raise ValueError(
                        "Sample boundary points failed, please check correctness of geometry and given criteria."
                    )
            normal = self.boundary_normal(x)

        normal_dict = convert_to_dict(
            (normal[:, 1:] if "t" in self.dim_keys else normal).astype(_DTYPE),
            [f"normal_{key}" for key in self.dim_keys if key != "t"],
        )
        x_dict = convert_to_dict(x, self.dim_keys)
        if is_mesh_time:
            return {**x_dict, **normal_dict, **convert_to_dict(area[:, 1:].astype(_DTYPE), ["area"])}
        return {**x_dict, **normal_dict}

    def sdf_derivatives(self, x: np.ndarray, epsilon: float = 1e-4) -> np.ndarray:
        """Central-difference derivatives of ``sdf_func``."""
        if not hasattr(self, "sdf_func"):
            raise NotImplementedError(
                f"{_typename(self)}.sdf_func should be implemented when using 'sdf_derivatives'."
            )
        sdf_derives = np.empty_like(x)
        for i in range(self.ndim):
            h = np.zeros_like(x)
            h[:, i] += epsilon / 2
            sdf_derives[:, i : i + 1] = (self.sdf_func(x + h) - self.sdf_func(x - h)) / epsilon
        return sdf_derives

    # -- CSG operators ------------------------------------------------------------
    def union(self, other: "Geometry") -> "Geometry":
        from paddlescience_torch.geometry import csg

        return csg.CSGUnion(self, other)

    def __or__(self, other: "Geometry") -> "Geometry":
        return self.union(other)

    def difference(self, other: "Geometry") -> "Geometry":
        from paddlescience_torch.geometry import csg

        return csg.CSGDifference(self, other)

    def __sub__(self, other: "Geometry") -> "Geometry":
        return self.difference(other)

    def intersection(self, other: "Geometry") -> "Geometry":
        from paddlescience_torch.geometry import csg

        return csg.CSGIntersection(self, other)

    def __and__(self, other: "Geometry") -> "Geometry":
        return self.intersection(other)

    def __str__(self) -> str:
        return ", ".join([self.__class__.__name__, f"ndim = {self.ndim}", f"bbox = {self.bbox}",
                          f"diam = {self.diam}", f"dim_keys = {self.dim_keys}"])
