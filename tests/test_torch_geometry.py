"""The port's geometry against paddlescience_tpu's on the CPU, bitwise.

Every geometry class of the port is built with the same arguments in both
packages. Their point queries (``is_inside``, ``on_boundary``,
``boundary_normal``, ``sdf_func``) must give identical arrays, and their
samples (interior, boundary, evenly spaced, initial; with and without
criteria, callable and string) must be bitwise the same from the same
``np.random`` seed: both packages are numpy and call it in the same order.
Covered: the 1-D, 2-D, 3-D and N-D shapes, the CSG of the cylinder2d
example and the other two operators, point clouds, and time-space
geometries on a random time axis, on a ``time_step`` grid and on
``timestamps``.
"""

import numpy as np
import pytest

import paddlescience_tpu.constraint as jconstraint
import paddlescience_tpu.geometry as jgeom
import paddlescience_tpu.loss as jloss
import paddlescience_torch.constraint as tconstraint
import paddlescience_torch.geometry as tgeom
import paddlescience_torch.loss as tloss

STAMPS = np.linspace(1.0, 50.0, 7).astype(np.float32)


def _cylinder(m):
    return m.Rectangle((-4.0, -4.0), (12.0, 4.0)) - m.Disk((0.0, 0.0), 1.0)


GEOMS = {
    "interval": lambda m: m.Interval(-1.0, 2.0),
    "disk": lambda m: m.Disk((0.5, -0.5), 1.5),
    "rectangle": lambda m: m.Rectangle((-1.0, 0.0), (2.0, 1.0)),
    "triangle": lambda m: m.Triangle((0.0, 0.0), (2.0, 0.0), (0.5, 1.5)),
    "polygon": lambda m: m.Polygon([(0.0, 0.0), (2.0, 0.0), (2.0, 1.0), (1.0, 2.0), (0.0, 1.0)]),
    "cuboid": lambda m: m.Cuboid((0.0, 0.0, 0.0), (1.0, 2.0, 0.5)),
    "sphere": lambda m: m.Sphere((0.0, 0.0, 0.0), 1.0),
    "hypercube": lambda m: m.Hypercube((0.0, -1.0, 0.0), (1.0, 1.0, 3.0)),
    "hypersphere": lambda m: m.Hypersphere((0.0, 1.0), 2.0),
    "csg_cylinder": _cylinder,
    "csg_union": lambda m: m.Rectangle((0.0, 0.0), (2.0, 1.0)) | m.Disk((2.0, 0.5), 0.75),
    "csg_intersection": lambda m: m.Rectangle((0.0, 0.0), (2.0, 1.0)) & m.Disk((1.0, 0.0), 1.2),
    "time_random": lambda m: m.TimeXGeometry(m.TimeDomain(0.0, 4.0), _cylinder(m)),
    "time_step": lambda m: m.TimeXGeometry(m.TimeDomain(0.0, 1.0, time_step=0.25), m.Interval(0.0, 1.0)),
    "time_stamps": lambda m: m.TimeXGeometry(m.TimeDomain(1.0, 50.0, timestamps=STAMPS), _cylinder(m)),
}
TIME_GEOMS = [k for k in GEOMS if k.startswith("time_")]
# a criteria per dimension that keeps about half of each shape
CRITERIA = {
    1: lambda x: x > 0.5,
    2: lambda x, y: x + y > 0.5,
    3: lambda x, y, z: x > 0.3,
}
TIME_CRITERIA = {2: lambda t, x: x > 0.5, 3: lambda t, x, y: (x > -1.0) & (y < 3.0)}


def _pair(name):
    return GEOMS[name](jgeom), GEOMS[name](tgeom)


def _assert_same(a, b):
    """Bitwise equal arrays, or dicts of them with the same keys."""
    if isinstance(a, dict):
        assert list(a) == list(b), (list(a), list(b))
        for k in a:
            _assert_same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True)


def _sampled(geom_fn, seed=0):
    np.random.seed(seed)
    return geom_fn()


def _queries(jg, seed=3):
    """Points around the bounding box, plus boundary points of the shape."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jg.bbox[0], np.float64)[0], np.asarray(jg.bbox[1], np.float64)[0]
    pad = 0.25 * (hi - lo)
    box = rng.uniform(lo - pad, hi + pad, (64, jg.ndim)).astype(np.float32)
    np.random.seed(seed)
    edge = jg.random_boundary_points(16)
    return box, edge if not isinstance(edge, tuple) else edge[0]


@pytest.mark.parametrize("name", list(GEOMS))
def test_point_queries_match(name):
    jg, tg = _pair(name)
    assert tg.ndim == jg.ndim and tg.dim_keys == jg.dim_keys
    _assert_same(jg.bbox[0], tg.bbox[0])
    _assert_same(jg.bbox[1], tg.bbox[1])
    assert tg.diam == jg.diam
    box, edge = _queries(jg)
    for pts in (box, edge):
        _assert_same(jg.is_inside(pts), tg.is_inside(pts))
        _assert_same(jg.on_boundary(pts), tg.on_boundary(pts))
        if hasattr(jg, "sdf_func"):
            _assert_same(jg.sdf_func(pts), tg.sdf_func(pts))
    on = jg.on_boundary(edge)
    assert on.any(), "no boundary point to take normals at"
    _assert_same(jg.boundary_normal(edge[on]), tg.boundary_normal(edge[on]))


@pytest.mark.parametrize("random", ["pseudo", "Halton", "Hammersley"])
@pytest.mark.parametrize("name", list(GEOMS))
def test_interior_samples_bitwise(name, random):
    jg, tg = _pair(name)
    _assert_same(_sampled(lambda: jg.sample_interior(64, random)), _sampled(lambda: tg.sample_interior(64, random)))


@pytest.mark.parametrize("name", list(GEOMS))
def test_boundary_samples_bitwise(name):
    jg, tg = _pair(name)
    _assert_same(_sampled(lambda: jg.sample_boundary(48)), _sampled(lambda: tg.sample_boundary(48)))


@pytest.mark.parametrize("name", list(GEOMS))
def test_evenly_samples_bitwise(name):
    """Evenly spaced interior and boundary points (random where a shape has
    no uniform sampler, in both packages alike)."""
    jg, tg = _pair(name)
    _assert_same(_sampled(lambda: jg.sample_interior(40, evenly=True)),
                 _sampled(lambda: tg.sample_interior(40, evenly=True)))
    _assert_same(_sampled(lambda: jg.sample_boundary(40, evenly=True)),
                 _sampled(lambda: tg.sample_boundary(40, evenly=True)))


@pytest.mark.parametrize("name", list(GEOMS))
def test_criteria_samples_bitwise(name):
    jg, tg = _pair(name)
    crit = (TIME_CRITERIA if name in TIME_GEOMS else CRITERIA)[jg.ndim]
    j_int = _sampled(lambda: jg.sample_interior(32, criteria=crit))
    _assert_same(j_int, _sampled(lambda: tg.sample_interior(32, criteria=crit)))
    assert crit(*[j_int[k] for k in jg.dim_keys]).all()
    _assert_same(_sampled(lambda: jg.sample_boundary(32, criteria=crit)),
                 _sampled(lambda: tg.sample_boundary(32, criteria=crit)))


@pytest.mark.parametrize("evenly", [False, True])
@pytest.mark.parametrize("name", TIME_GEOMS)
def test_initial_samples_bitwise(name, evenly):
    jg, tg = _pair(name)
    j_ic = _sampled(lambda: jg.sample_initial_interior(36, evenly=evenly))
    _assert_same(j_ic, _sampled(lambda: tg.sample_initial_interior(36, evenly=evenly)))
    assert np.all(j_ic["t"] == jg.timedomain.t0)


@pytest.mark.parametrize("name", ["time_step", "time_stamps"])
def test_time_grids(name):
    """Interior and boundary samples take their times from the grid (the
    stamps after t0), ``nx`` spatial points per time."""
    jg, tg = _pair(name)
    td = tg.timedomain
    grid = (np.linspace(td.t1, td.t0, num=int(np.ceil(td.diam / td.time_step)), endpoint=False,
                        dtype=np.float32)[::-1] if td.time_step is not None else STAMPS[1:])
    for kind in ("sample_interior", "sample_boundary"):
        np.random.seed(1)
        t_pts = getattr(tg, kind)(len(grid) * 5)
        _assert_same(np.unique(t_pts["t"]), np.unique(grid))
        np.random.seed(1)
        _assert_same(getattr(jg, kind)(len(grid) * 5), t_pts)
    assert td.num_timestamps == jg.timedomain.num_timestamps


def test_pointcloud_matches():
    rng = np.random.default_rng(0)
    interior = {k: rng.uniform(0, 1, (20, 1)).astype(np.float32) for k in ("x", "y")}
    boundary = {k: rng.uniform(0, 1, (10, 1)).astype(np.float32) for k in ("x", "y")}
    normal = {f"normal_{k}": rng.normal(size=(10, 1)).astype(np.float32) for k in ("x", "y")}
    jg = jgeom.PointCloud(interior, ("x", "y"), boundary, normal)
    tg = tgeom.PointCloud(interior, ("x", "y"), boundary, normal)
    _assert_same(_sampled(lambda: jg.sample_interior(30)), _sampled(lambda: tg.sample_interior(30)))
    _assert_same(_sampled(lambda: jg.sample_boundary(15)), _sampled(lambda: tg.sample_boundary(15)))
    pts = np.concatenate([interior["x"], interior["y"]], axis=1)
    _assert_same(jg.is_inside(pts), tg.is_inside(pts))


def test_build_geometry_matches():
    cfg = [{"name": "Rectangle", "xmin": (0.0, 0.0), "xmax": (1.0, 2.0)},
           {"name": "TimeXGeometry", "timedomain": {"name": "TimeDomain", "t0": 0.0, "t1": 1.0},
            "geometry": {"name": "Disk", "center": (0.0, 0.0), "radius": 1.0}}]
    jd, td = jgeom.build_geometry(cfg), tgeom.build_geometry(cfg)
    assert list(td) == list(jd) == ["Rectangle", "TimeXGeometry"]
    for k in jd:
        assert type(td[k]).__name__ == type(jd[k]).__name__
        _assert_same(_sampled(lambda: jd[k].sample_interior(16)), _sampled(lambda: td[k].sample_interior(16)))
    with pytest.raises(ValueError, match="unknown geometry"):
        tgeom.build_geometry({"name": "Nope"})


def _constraint_data(mod, geom, cls, criteria, **kw):
    np.random.seed(5)
    c = getattr(mod.constraint, cls)({"u": lambda out: out["u"]}, {"u": 1.5}, geom,
                                     {"dataset": "IterableNamedArrayDataset", "batch_size": 24},
                                     mod.loss.MSELoss(), criteria=criteria, name=cls, **kw)
    return c.dataset.input, c.dataset.label


class _J:
    constraint, loss = jconstraint, jloss


class _T:
    constraint, loss = tconstraint, tloss


@pytest.mark.parametrize("cls", ["InteriorConstraint", "BoundaryConstraint", "InitialConstraint"])
@pytest.mark.parametrize("form", ["callable", "string"])
def test_constraint_samples_with_criteria_bitwise(cls, form):
    """The constraints' inputs and labels on the cylinder's time-space
    domain, with the criteria as a callable and as a string that evaluates
    to it."""
    text = "lambda t, x, y: (x > -2.0) | (y > 1.0)"
    crit = eval(text) if form == "callable" else text  # noqa: S307
    jg, tg = _pair("time_stamps")
    j_in, j_lab = _constraint_data(_J, jg, cls, crit)
    t_in, t_lab = _constraint_data(_T, tg, cls, crit)
    _assert_same(j_in, t_in)
    _assert_same(j_lab, t_lab)
    assert ((j_in["x"] > -2.0) | (j_in["y"] > 1.0)).all()
