"""``SDFMesh`` and the LDC curriculum's ``mixed_curriculum_precision`` in
the port.

``SDFMesh`` against the JAX package's on a small closed mesh: the same
samples (bitwise, same numpy seed), signed distances and inside test, and
its type name accepted where a mesh is expected (time-space sampling).
The precision knob: the TF32 flags each stage of a curriculum trains
under, restored after the run, also when a stage raises.
"""

import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_torch import geometry as tgeo
from paddlescience_torch.examples import ldc_curriculum as tldc


def _box_mesh():
    """A closed unit cube as (vertices, faces), outward normals."""
    v = np.array([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)], np.float32)
    f = np.array([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6], [0, 1, 4], [1, 5, 4], [2, 6, 3], [3, 6, 7],
                  [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]], np.int64)
    return v, f


def test_sdfmesh_is_a_mesh_with_the_jax_packages_samples():
    v, f = _box_mesh()
    jm, tm = psci.geometry.SDFMesh((v, f)), tgeo.SDFMesh((v, f))
    assert isinstance(tm, tgeo.Mesh) and type(tm).__name__ == "SDFMesh"
    np.random.seed(3)
    want = jm.sample_interior(64)
    np.random.seed(3)
    got = tm.sample_interior(64)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    pts = np.random.default_rng(1).uniform(-0.5, 1.5, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.sdf_func(pts), np.asarray(jm.sdf_func(pts)), rtol=1e-5, atol=1e-6)
    assert np.array_equal(tm.is_inside(pts), np.asarray(jm.is_inside(pts)))


def test_sdfmesh_from_stl_and_in_a_time_product(tmp_path):
    v, f = _box_mesh()
    path = tmp_path / "box.stl"
    with open(path, "w") as fh:
        fh.write("solid box\n")
        for tri in f:
            fh.write(" facet normal 0 0 0\n  outer loop\n")
            for i in tri:
                fh.write(f"   vertex {v[i][0]} {v[i][1]} {v[i][2]}\n")
            fh.write("  endloop\n endfacet\n")
        fh.write("endsolid box\n")
    mesh = tgeo.SDFMesh.from_stl(str(path))
    assert isinstance(mesh, tgeo.SDFMesh) and mesh.faces.shape == (12, 3)
    geo = tgeo.TimeXGeometry(tgeo.TimeDomain(0.0, 1.0), mesh)
    np.random.seed(0)
    pts = geo.sample_interior(32)
    assert set(pts) >= {"t", "x", "y", "z"} and pts["x"].shape == (32, 1)
    jgeo = psci.geometry.TimeXGeometry(psci.geometry.TimeDomain(0.0, 1.0), psci.geometry.SDFMesh.from_stl(str(path)))
    np.random.seed(0)
    want = jgeo.sample_interior(32)
    for k in ("t", "x", "y", "z"):
        assert np.array_equal(pts[k], np.asarray(want[k])), k


class _Stage:
    """A stand-in for a stage's solver that records the TF32 flags its
    training ran under."""

    seen = []
    fail_at = None

    def __init__(self, Re):
        self.Re = Re
        self.graph_stats, self.agg_state, self.step = {}, {"weight": torch.ones(5)}, 0

    def train(self, k=None):
        _Stage.seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        if self.Re == _Stage.fail_at:
            raise RuntimeError("a stage failed")
        return []

    def eval(self):
        return 0.0, {}

    state = None

    def release_graphs(self):
        pass


@pytest.fixture
def stub_stages(monkeypatch):
    monkeypatch.setattr(tldc, "make_model", lambda cfg, device: None)
    monkeypatch.setattr(tldc, "make_training", lambda cfg, model: (None, None))
    monkeypatch.setattr(tldc, "build_stage_solver", lambda cfg, m, o, g, Re, *a: _Stage(Re))
    monkeypatch.setattr(tldc, "ghia_report", lambda model, Re: {})
    _Stage.seen, _Stage.fail_at = [], None
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("mixed", [False, True])
def test_mixed_curriculum_precision_sets_and_restores_tf32_per_stage(stub_stages, mixed):
    cfg = tldc.re3200_sota(mixed_curriculum_precision=mixed)
    assert tldc.re3200_piratenet()["mixed_curriculum_precision"] is False  # off unless asked, as in JAX
    results = tldc.train_curriculum(cfg, output_dir=None, device="cpu")
    n = len(cfg["Re"])
    want = [mixed and i < n - 1 for i in range(n)]
    assert [r["tf32"] for r in results] == want
    assert _Stage.seen == [(w, w) for w in want]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)


def test_mixed_curriculum_precision_restores_the_flags_when_a_stage_fails(stub_stages):
    cfg = tldc.re3200_sota(mixed_curriculum_precision=True)
    _Stage.fail_at = cfg["Re"][1]
    with pytest.raises(RuntimeError, match="a stage failed"):
        tldc.train_curriculum(cfg, output_dir=None, device="cpu")
    assert _Stage.seen == [(True, True), (True, True)]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)
