"""Geometry (counterpart of ``paddlescience_tpu/geometry``): host-side
numpy sampling, as in the JAX package, bitwise the same points from the
same ``np.random`` seed. The ``Geometry`` base with the CSG operators,
the 1-D, 2-D, 3-D and N-D shapes, CSG, the time domain and time-space
product, point clouds, the STL ``Mesh`` and its ``SDFMesh`` twin, and
:func:`build_geometry`."""

import copy

from paddlescience_torch.geometry.csg import CSGDifference, CSGIntersection, CSGUnion
from paddlescience_torch.geometry.geometry import Geometry
from paddlescience_torch.geometry.geometry_1d import Interval
from paddlescience_torch.geometry.geometry_2d import Disk, Polygon, Rectangle, Triangle
from paddlescience_torch.geometry.geometry_3d import Cuboid, Sphere
from paddlescience_torch.geometry.geometry_nd import Hypercube, Hypersphere
from paddlescience_torch.geometry.mesh import Mesh, SDFMesh, load_stl
from paddlescience_torch.geometry.pointcloud import PointCloud
from paddlescience_torch.geometry.timedomain import TimeDomain, TimeXGeometry

__all__ = ["Geometry", "Interval", "Disk", "Rectangle", "Triangle", "Polygon", "Cuboid", "Sphere", "Hypercube",
           "Hypersphere", "CSGUnion", "CSGDifference", "CSGIntersection", "PointCloud", "Mesh", "SDFMesh",
           "load_stl", "TimeDomain", "TimeXGeometry", "build_geometry"]


def build_geometry(cfg):
    """Geometry from a config dict ``{"name": ClassName, **kwargs}`` (a
    ``TimeXGeometry`` takes ``timedomain`` and ``geometry`` sub-configs), or
    ``{name: geometry}`` from a list of them."""
    cfg = copy.deepcopy(cfg)
    if isinstance(cfg, (list, tuple)):
        return {item["name"]: build_geometry(item) for item in cfg}
    cfg = dict(cfg)
    name = cfg.pop("name")
    if name == "TimeXGeometry":
        timedomain = build_geometry(cfg.pop("timedomain"))
        geom = build_geometry(cfg.pop("geometry"))
        return TimeXGeometry(timedomain, geom)
    cls = globals().get(name)
    if cls is None or not (isinstance(cls, type) and issubclass(cls, Geometry)):
        raise ValueError(f"unknown geometry '{name}'")
    return cls(**cfg)
