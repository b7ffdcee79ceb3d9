"""The port's C++ mesh ray cast and distances (``csrc/mesh_raycast.cpp``,
built with g++ at first use) against their numpy versions and the JAX
package's numpy branch, on the control arm's capsule STL and on a cube:
hit counts bitwise equal, so the inside test keeps bitwise the same
sampled points; unsigned distances and the sdf within 1e-6 relative (the
numpy version expands |v0 + s e1 + t e2 - p|^2 into matrix products, the
library sums per triangle). A failed build raises.
"""

import numpy as np
import pytest

from paddlescience_tpu import native as jnative
from paddlescience_tpu.geometry.mesh import Mesh as JMesh
from paddlescience_torch.examples.control_arm import write_arm_stl
from paddlescience_torch.geometry import raycast
from paddlescience_torch.geometry.mesh import Mesh as TMesh

CUBE_V = np.array([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)], np.float32)
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                   [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)


@pytest.fixture(scope="module")
def arm_stl(tmp_path_factory):
    return write_arm_stl(str(tmp_path_factory.mktemp("arm") / "control_arm.stl"))


def _pair(kind, arm_stl):
    src = arm_stl if kind == "capsule" else (CUBE_V, CUBE_F)
    return TMesh(src), TMesh(src, native=False)


@pytest.mark.parametrize("kind", ["capsule", "cube"])
def test_hit_counts_are_bitwise_equal_and_distances_close(kind, arm_stl):
    native, plain = _pair(kind, arm_stl)
    lo, hi = native.bbox[0][0] - 0.3, native.bbox[1][0] + 0.3
    pts = np.random.default_rng(0).uniform(lo, hi, (3000, 3))
    # points on the cube's faces, edges and corners: the ray's degenerate cases
    pts[:200] = np.random.default_rng(1).integers(0, 3, (200, 3)) * 0.5 if kind == "cube" else pts[:200]
    for d in (np.array([0.3, -0.5, 0.8]), np.array([0.0, 0.0, 1.0]), np.random.default_rng(0).normal(size=3)):
        np.testing.assert_array_equal(native._ray_hits(pts, d), plain._ray_hits(pts, d))
    np.testing.assert_array_equal(native.is_inside(pts), plain.is_inside(pts))
    dn, dp = native._unsigned_distance(pts), plain._unsigned_distance(pts)
    np.testing.assert_allclose(dn, dp, rtol=1e-6, atol=1e-6 * dp.max())
    np.testing.assert_allclose(native.sdf_func(pts), plain.sdf_func(pts), rtol=1e-6, atol=1e-6 * dp.max())


@pytest.mark.parametrize("kind", ["capsule", "cube"])
def test_sampled_points_are_those_of_the_numpy_version_and_of_jax(kind, arm_stl, monkeypatch):
    """From one seed the native mesh samples bitwise the interior points
    of its numpy version and of the JAX package's numpy branch; the sdf
    column agrees within 1e-6."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    native, plain = _pair(kind, arm_stl)
    jmesh = JMesh(arm_stl if kind == "capsule" else (CUBE_V, CUBE_F))
    draws = {}
    for name, mesh in (("native", native), ("plain", plain), ("jax", jmesh)):
        np.random.seed(5)
        draws[name] = mesh.sample_interior(400)
    for name in ("plain", "jax"):
        for k in ("x", "y", "z"):
            np.testing.assert_array_equal(draws["native"][k], draws[name][k], err_msg=f"{name} {k}")
        ref = draws[name]["sdf"]
        np.testing.assert_allclose(draws["native"]["sdf"], ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "mesh_raycast.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(raycast, "SOURCE", bad)
    monkeypatch.setattr(raycast, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(raycast, "_LIB", None)
    with pytest.raises(RuntimeError, match="building mesh_raycast.cpp failed"):
        raycast.load()
    with pytest.raises(RuntimeError, match="building"):
        TMesh((CUBE_V, CUBE_F)).is_inside(np.zeros((2, 3)))


def test_the_library_is_keyed_by_source_flags_and_machine(tmp_path, monkeypatch):
    path = raycast.library_path()
    assert path.parent.name == "_build" and path.name.startswith("libmesh_raycast-")
    assert "-march=native" not in raycast.FLAGS and "-ffp-contract=off" in raycast.FLAGS
    monkeypatch.setattr(raycast.platform, "machine", lambda: "another")
    assert raycast.library_path() != path
