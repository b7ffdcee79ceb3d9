"""The LDC reference data of the port against the JAX package's tools on the
CPU: the cavity generator (``data/dataset/ldc_reference.py``) against
``tools/gen_ldc_reference.py``, its cache, and the Ghia et al. (1982)
tables of ``utils/ghia.py`` against ``paddlescience_tpu/utils/ghia.py``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_tpu.utils import ghia as jghia
from paddlescience_torch.data.dataset import ldc_reference as tref
from paddlescience_torch.utils import ghia as tghia

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import gen_ldc_reference as jgen  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The generator's thousands of small FFTs and stencils on the CPU: at
    torch's default thread count they run some 30x slower when other
    processes share the cores (the test runner's workers), at one thread
    they do not; the arithmetic is the same."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------- generator --


def test_cavity_generator_matches_the_tool_at_n33():
    """One 2000-step chunk at Re 100 on 33^2: u, v, psi and omega within
    1e-5 of the largest magnitude of the tool's (float32 in both; the FFT
    libraries round differently), the grid bitwise."""
    ref = jgen.solve_cavity(100.0, n=33, steps=2000, report=lambda m: None)
    got = tref.solve_cavity(100.0, n=33, steps=2000, device="cpu", report=lambda m: None)
    for k in ("u", "v", "psi", "omega"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5 * np.abs(ref[k]).max())
    assert np.array_equal(got["x"], ref["x"]) and np.array_equal(got["y"], ref["y"])
    assert int(got["steps"]) == 2000


def test_dst_and_poisson_match_the_tool():
    """The DST-I along each axis within 1e-6 and the Poisson solve (four
    transforms) within 1e-5 of the largest magnitude: same sign, same
    scale, only the FFT's float32 rounding apart."""
    rhs = np.random.default_rng(2).standard_normal((31, 31)).astype(np.float32)
    for axis in (0, 1):
        _close(tref.dst1(torch.from_numpy(rhs), axis), jgen.dst1(jnp.asarray(rhs), axis), 1e-6)
    got = tref.poisson_dst(torch.from_numpy(rhs), 1 / 32).numpy()
    ref = np.asarray(jgen.poisson_dst(jnp.asarray(rhs), 1 / 32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_load_reference_caches_and_names_files(tmp_path):
    assert os.path.basename(tref.reference_path(400.0)) == "ldc_Re400.npz"
    assert os.path.basename(tref.reference_path(400.0, n=17)) == "ldc_Re400_n17.npz"
    first = tref.load_reference(100.0, n=9, cache_dir=str(tmp_path), device="cpu", report=lambda m: None)
    assert os.path.exists(tmp_path / "ldc_Re100_n9.npz") and first["u"].shape == (9, 9)
    again = tref.load_reference(100.0, n=9, cache_dir=str(tmp_path), device="cpu")
    assert all(np.array_equal(first[k], again[k]) for k in first)


# -------------------------------------------------------------- ghia --


def test_ghia_tables_equal_jax_bitwise():
    assert sorted(tghia.GHIA_TABLES) == sorted(jghia.GHIA_TABLES)
    for Re, tab in jghia.GHIA_TABLES.items():
        assert sorted(tghia.GHIA_TABLES[Re]) == sorted(tab)
        for k, v in tab.items():
            assert tghia.GHIA_TABLES[Re][k].dtype == v.dtype and np.array_equal(tghia.GHIA_TABLES[Re][k], v)

    def uv_fn(x, y):
        return {"u": np.sin(3 * y) * x, "v": np.cos(2 * x) * y}

    for Re in (100, 1000):
        assert tghia.profile_rmse(uv_fn, Re) == jghia.profile_rmse(uv_fn, Re)
    with pytest.raises(KeyError, match="Ghia tables embedded only"):
        tghia.profiles(3200)
