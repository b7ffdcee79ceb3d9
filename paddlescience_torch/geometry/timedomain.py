"""Time domain and time-space product geometry (counterpart of
``paddlescience_tpu/geometry/timedomain.py``, a numpy copy)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from paddlescience_torch.geometry import geometry, geometry_1d, sampler

__all__ = ["TimeDomain", "TimeXGeometry"]

_DTYPE = np.float32


class TimeDomain(geometry_1d.Interval):
    """[t0, t1] with optional fixed time_step or explicit timestamps."""

    def __init__(
        self,
        t0: float,
        t1: float,
        time_step: Optional[float] = None,
        timestamps: Optional[Tuple[float, ...]] = None,
    ):
        super().__init__(t0, t1)
        self.t0 = t0
        self.t1 = t1
        self.time_step = time_step
        self.timestamps = (
            None if timestamps is None else np.array(timestamps, dtype=_DTYPE).reshape([-1])
        )
        if time_step is not None:
            if time_step <= 0:
                raise ValueError(f"time_step({time_step}) must be larger than 0.")
            self.num_timestamps = int(np.ceil((t1 - t0) / time_step)) + 1
        elif timestamps is not None:
            self.num_timestamps = len(timestamps)

    def on_initial(self, t: np.ndarray) -> np.ndarray:
        return np.isclose(t, self.t0).flatten()


class TimeXGeometry(geometry.Geometry):
    """Product of a TimeDomain and a spatial geometry; dim_keys = (t, x, ...)."""

    def __init__(self, timedomain: TimeDomain, geometry_: geometry.Geometry):
        self.timedomain = timedomain
        self.geometry = geometry_
        super().__init__(
            geometry_.ndim + 1,
            (
                np.concatenate([timedomain.bbox[0], geometry_.bbox[0]], axis=-1),
                np.concatenate([timedomain.bbox[1], geometry_.bbox[1]], axis=-1),
            ),
            (timedomain.diam**2 + geometry_.diam**2) ** 0.5,
        )

    @property
    def dim_keys(self):
        return ("t",) + self.geometry.dim_keys

    def is_inside(self, x):
        return np.logical_and(
            self.timedomain.is_inside(x[:, :1]), self.geometry.is_inside(x[:, 1:])
        )

    def on_boundary(self, x):
        return self.geometry.on_boundary(x[:, 1:])

    def on_initial(self, x):
        return self.timedomain.on_initial(x[:, :1])

    def boundary_normal(self, x):
        normal = self.geometry.boundary_normal(x[:, 1:])
        return np.hstack((np.zeros((len(normal), 1), dtype=_DTYPE), normal))

    def _sample_spatial(self, nx: int, random: str, criteria: Optional[Callable]) -> np.ndarray:
        """Rejection-sample nx spatial points; criteria gets (None, x, y, ...)"""
        x = np.empty((nx, self.geometry.ndim), dtype=_DTYPE)
        _size, _ntry, _nsuc = 0, 0, 0
        while _size < nx:
            _x = self.geometry.random_points(nx, random)
            if criteria is not None:
                mask = criteria(None, *np.split(_x, self.geometry.ndim, axis=1)).flatten()
                _x = _x[mask]
            if len(_x) > nx - _size:
                _x = _x[: nx - _size]
            x[_size : _size + len(_x)] = _x
            _size += len(_x)
            _ntry += 1
            if len(_x) > 0:
                _nsuc += 1
            if _ntry >= 1000 and _nsuc == 0:
                raise ValueError("Sample points failed; check geometry and criteria.")
        return x

    def random_points(self, n: int, random: str = "pseudo", criteria: Optional[Callable] = None) -> np.ndarray:
        # fixed time grid x random space
        if self.timedomain.time_step is not None or self.timedomain.timestamps is not None:
            if self.timedomain.time_step is not None:
                nt = int(np.ceil(self.timedomain.diam / self.timedomain.time_step))
                t = np.linspace(
                    self.timedomain.t1, self.timedomain.t0, num=nt, endpoint=False, dtype=_DTYPE
                )[::-1]
            else:
                t = self.timedomain.timestamps[1:]
                nt = len(t)
            nx = int(np.ceil(n / nt))
            x = self._sample_spatial(nx, random, criteria)
            tx = np.vstack(
                [np.hstack((np.full([nx, 1], ti, dtype=_DTYPE), x)) for ti in t]
            )
            return tx[:n] if len(tx) > n else tx

        # fully random time x space
        x = self.geometry.random_points(n, random=random)
        t = np.random.permutation(self.timedomain.random_points(n, random=random))
        return np.hstack((t, x))

    def uniform_points(self, n: int, boundary: bool = True) -> np.ndarray:
        nt = self.timedomain.num_timestamps if self.timedomain.time_step else int(np.ceil(np.sqrt(n)))
        nx = int(np.ceil(n / nt))
        x = self.geometry.uniform_points(nx, boundary=boundary)
        nx = len(x)
        t = np.linspace(self.timedomain.t0, self.timedomain.t1, nt, dtype=_DTYPE)
        tx = np.vstack([np.hstack((np.full([nx, 1], ti, dtype=_DTYPE), x)) for ti in t])
        return tx[:n] if len(tx) > n else tx

    def _is_mesh(self) -> bool:
        return type(self.geometry).__name__ in ("Mesh", "SDFMesh")

    def _mesh_surface_sample(self, nx: int, criteria: Optional[Callable]):
        """Exactly-nx (points, normals, areas), criteria-filtered with all
        three kept aligned."""
        geom = self.geometry
        x = np.empty((nx, geom.ndim), dtype=_DTYPE)
        nrm = np.empty((nx, geom.ndim), dtype=_DTYPE)
        ar = np.empty((nx, 1), dtype=_DTYPE)
        _size, _ntry, _nsuc = 0, 0, 0
        while _size < nx:
            _x, _n, _a = geom._sample_surface(nx)
            if criteria is not None:
                mask = criteria(None, *np.split(_x, geom.ndim, axis=1)).flatten()
                _x, _n, _a = _x[mask], _n[mask], _a[mask]
            take = min(len(_x), nx - _size)
            x[_size : _size + take] = _x[:take]
            nrm[_size : _size + take] = _n[:take]
            ar[_size : _size + take] = _a[:take]
            _size += take
            _ntry += 1
            if take > 0:
                _nsuc += 1
            if _ntry >= 10000 and _nsuc == 0:
                raise ValueError("Sample boundary points failed.")
        return x, nrm, ar

    def _boundary_time_grid(self):
        """Timestamps for the fixed-time-grid boundary sampling branch."""
        if self.timedomain.time_step is not None:
            nt = int(np.ceil(self.timedomain.diam / self.timedomain.time_step))
            t = np.linspace(
                self.timedomain.t1, self.timedomain.t0, num=nt, endpoint=False, dtype=_DTYPE
            )[::-1]
        else:
            t = self.timedomain.timestamps[1:]
        return t

    def random_boundary_points(self, n: int, random: str = "pseudo", criteria: Optional[Callable] = None):
        """Boundary points over time. For Mesh/SDFMesh spatial geometries
        returns an aligned (points, normals, areas) triple — all with a
        leading time column, which ``Geometry.sample_boundary`` strips."""
        is_mesh = self._is_mesh()
        if self.timedomain.time_step is not None or self.timedomain.timestamps is not None:
            t = self._boundary_time_grid()
            nt = len(t)
            nx = int(np.ceil(n / nt))
            if is_mesh:
                x, nrm, ar = self._mesh_surface_sample(nx, criteria)
            else:
                x = np.empty((nx, self.geometry.ndim), dtype=_DTYPE)
                _size, _ntry, _nsuc = 0, 0, 0
                while _size < nx:
                    _x = self.geometry.random_boundary_points(nx, random)
                    if criteria is not None:
                        mask = criteria(None, *np.split(_x, self.geometry.ndim, axis=1)).flatten()
                        _x = _x[mask]
                    if len(_x) > nx - _size:
                        _x = _x[: nx - _size]
                    x[_size : _size + len(_x)] = _x
                    _size += len(_x)
                    _ntry += 1
                    if len(_x) > 0:
                        _nsuc += 1
                    if _ntry >= 10000 and _nsuc == 0:
                        raise ValueError("Sample boundary points failed.")
            def _tile(arr):
                return np.vstack(
                    [np.hstack((np.full([len(arr), 1], ti, dtype=_DTYPE), arr)) for ti in t]
                )[:n]
            if is_mesh:
                return _tile(x), _tile(nrm), _tile(ar)
            tx = _tile(x)
            return tx

        t = np.random.permutation(self.timedomain.random_points(n, random=random))
        if is_mesh:
            x, nrm, ar = self._mesh_surface_sample(n, criteria)
            return (
                np.hstack((t, x)),
                np.hstack((np.zeros_like(t), nrm)),
                np.hstack((np.zeros_like(t), ar)),
            )
        x = self.geometry.random_boundary_points(n, random=random)
        return np.hstack((t, x))

    def uniform_boundary_points(self, n: int):
        """Uniform time grid x spatial boundary. For mesh spatial geometries
        there is no uniform surface sampler; area-weighted random surface
        sampling is used per timestamp (triple return, as above)."""
        nt = self.timedomain.num_timestamps if self.timedomain.time_step else int(np.ceil(np.sqrt(n)))
        nx = int(np.ceil(n / nt))
        t = np.linspace(self.timedomain.t0, self.timedomain.t1, nt, dtype=_DTYPE)
        def _tile(arr):
            return np.vstack(
                [np.hstack((np.full([len(arr), 1], ti, dtype=_DTYPE), arr)) for ti in t]
            )[:n]
        if self._is_mesh():
            x, nrm, ar = self._mesh_surface_sample(nx, None)
            return _tile(x), _tile(nrm), _tile(ar)
        x = self.geometry.uniform_boundary_points(nx)
        return _tile(x)

    def uniform_initial_points(self, n: int) -> np.ndarray:
        x = self.geometry.uniform_points(n, True)
        t = np.full([len(x), 1], self.timedomain.t0, dtype=_DTYPE)
        return np.hstack((t, x))[:n]

    def random_initial_points(self, n: int, random: str = "pseudo") -> np.ndarray:
        x = self.geometry.random_points(n, random=random)
        t = np.full([n, 1], self.timedomain.t0, dtype=_DTYPE)
        return np.hstack((t, x))

    def sample_initial_interior(
        self,
        n: int,
        random: str = "pseudo",
        criteria: Optional[Callable] = None,
        evenly: bool = False,
        compute_sdf_derivatives: bool = False,
    ):
        """Sample interior points at t = t0."""
        x = np.empty(shape=(n, self.ndim), dtype=_DTYPE)
        _size, _ntry, _nsuc = 0, 0, 0
        while _size < n:
            if evenly:
                points = self.uniform_initial_points(n)
            else:
                points = self.random_initial_points(n, random)
            if criteria is not None:
                mask = criteria(*np.split(points, self.ndim, axis=1)).flatten()
                points = points[mask]
            if len(points) > n - _size:
                points = points[: n - _size]
            x[_size : _size + len(points)] = points
            _size += len(points)
            _ntry += 1
            if len(points) > 0:
                _nsuc += 1
            if _ntry >= 1000 and _nsuc == 0:
                raise ValueError("Sample initial interior points failed.")

        x_dict = geometry.convert_to_dict(x, self.dim_keys)
        if hasattr(self.geometry, "sdf_func"):
            sdf = -self.geometry.sdf_func(x[:, 1:])
            sdf_dict = geometry.convert_to_dict(sdf.astype(_DTYPE), ("sdf",))
            sdf_derives_dict = {}
            if compute_sdf_derivatives:
                sdf_derives = -self.geometry.sdf_derivatives(x[:, 1:])
                sdf_derives_dict = geometry.convert_to_dict(
                    sdf_derives.astype(_DTYPE),
                    tuple(f"sdf__{k}" for k in self.geometry.dim_keys),
                )
            return {**x_dict, **sdf_dict, **sdf_derives_dict}
        return x_dict

    def periodic_point(self, x, component: int):
        """Periodic image along a spatial component; keeps t column."""
        xs = {k: v for k, v in x.items() if k != "t"}
        y = self.geometry.periodic_point(xs, component)
        return {"t": x["t"], **y}

    def sdf_func(self, points: np.ndarray) -> np.ndarray:
        if not hasattr(self.geometry, "sdf_func"):
            raise NotImplementedError
        return self.geometry.sdf_func(points[:, 1:])

    def __str__(self):
        return ", ".join(
            [
                self.__class__.__name__,
                f"ndim = {self.ndim}",
                f"timedomain = [{self.timedomain.t0}, {self.timedomain.t1}]",
                f"geometry = {self.geometry}",
                f"dim_keys = {self.dim_keys}",
            ]
        )
