"""The port's spherical slice against paddlescience_tpu on the CPU: the
Legendre tables and quadrature rules (bitwise), the JAX package's own SHT
properties (``tests/test_sht.py``: round trip, a single harmonic, Parseval)
on the port's transforms, ``RealSHT`` / ``InverseRealSHT`` against JAX on
every grid (coefficients not Hermitian at m = 0), ``SFNONet``,
``SphericalSWEDataset`` and the sfno_swe example.

JAX runs at "highest" matmul precision (``_operator_parity.py``).
Tolerances (relative to the largest magnitude of the JAX value): forwards
1e-5, parameter gradients 1e-4, three train steps 1e-4; data bitwise.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _operator_parity import arch_parity, close, highest_precision, three_steps  # noqa: F401
from paddlescience_tpu.arch import sht as jsht
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import sfnonet as tsfno
from paddlescience_torch.arch import sht as tsht
from paddlescience_torch.data.dataset import domain_dataset as tdd
from paddlescience_torch.examples import sfno_swe as tswe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import sfno_swe as jswe  # noqa: E402  (the JAX example)


# ------------------------------------------------------------------ SHT --

def test_legendre_tables_and_quadrature_are_the_jax_packages():
    for n in (7, 16):
        for a, b in zip(tsht.legendre_gauss_weights(n), jsht.legendre_gauss_weights(n)):
            assert np.array_equal(a, b)
        for a, b in zip(tsht.clenshaw_curtiss_weights(n), jsht.clenshaw_curtiss_weights(n)):
            assert np.array_equal(a, b)
    x, _ = jsht.legendre_gauss_weights(12)
    assert np.array_equal(tsht.precompute_legpoly(5, 9, x), jsht.precompute_legpoly(5, 9, x))


@pytest.mark.parametrize("grid", ["legendre-gauss", "equiangular"])
def test_sht_roundtrip_bandlimited(grid):
    """The JAX package's property (``tests/test_sht.py``): isht(sht(f)) = f
    for a band-limited f (equiangular truncated to l, m < 10)."""
    nlat, nlon = 24, 48
    trunc = dict(lmax=10, mmax=10) if grid == "equiangular" else {}
    sht, isht = tsht.RealSHT(nlat, nlon, grid=grid, **trunc), tsht.InverseRealSHT(nlat, nlon, grid=grid, **trunc)
    rng = np.random.default_rng(0)
    coeffs = np.zeros((sht.lmax, sht.mmax), np.complex64)
    for l in range(0, 8):
        for m in range(0, min(l + 1, 6)):
            coeffs[l, m] = rng.normal() + 1j * rng.normal() * (m > 0)
    f = isht(torch.from_numpy(coeffs))
    assert torch.isfinite(f).all() and f.abs().max() > 0
    f2 = isht(sht(f))
    np.testing.assert_allclose(f2.numpy(), f.numpy(), rtol=2e-3, atol=2e-3 * float(f.abs().max()))


def test_sht_analysis_picks_mode_and_keeps_parseval():
    nlat, nlon = 16, 32
    sht = tsht.RealSHT(nlat, nlon, grid="legendre-gauss")
    cost, w = tsht.legendre_gauss_weights(nlat)
    phi = 2 * np.pi * np.arange(nlon) / nlon
    ptab = tsht.precompute_legpoly(3, 4, cost)
    f = (ptab[2, 3][:, None] * np.cos(2 * phi)[None, :]).astype(np.float32)
    mag = sht(torch.from_numpy(f)).abs().numpy()
    idx = np.unravel_index(np.argmax(mag), mag.shape)
    assert idx == (3, 2)
    rest = mag.copy()
    rest[idx] = 0
    assert rest.max() < 1e-4 * mag[idx]
    a = sht(torch.from_numpy(f)).numpy().astype(np.complex128)
    mult = np.ones(sht.mmax)
    mult[1:] = 2.0
    surf = np.einsum("tp,t->", f.astype(np.float64) ** 2, w) * (2 * np.pi / nlon)
    np.testing.assert_allclose(float(np.sum(np.abs(a) ** 2 * mult[None, :])), surf, rtol=2e-3)


@pytest.mark.parametrize("grid,lm", [("lobatto", (6, 5)), ("equiangular", (5, 4)), ("legendre-gauss", (None, None))])
def test_sht_pair_matches_jax(grid, lm):
    """Forward on a random field and inverse on random (not Hermitian at
    m = 0) coefficients: the DC mode's imaginary part is dropped as JAX
    drops it."""
    nlat, nlon = 9, 16
    lmax, mmax = lm
    js, ji = jsht.RealSHT(nlat, nlon, lmax, mmax, grid=grid), jsht.InverseRealSHT(nlat, nlon, lmax, mmax, grid=grid)
    ts, ti = tsht.RealSHT(nlat, nlon, lmax, mmax, grid=grid), tsht.InverseRealSHT(nlat, nlon, lmax, mmax, grid=grid)
    assert torch.equal(ts.weights, torch.from_numpy(np.asarray(js.weights)))
    rng = np.random.default_rng(8)
    f = rng.standard_normal((2, nlat, nlon)).astype(np.float32)
    close(ts(torch.from_numpy(f)), np.asarray(js(jnp.asarray(f))), 1e-5)
    c = (rng.standard_normal((2, ts.lmax, ts.mmax)) + 1j * rng.standard_normal((2, ts.lmax, ts.mmax))).astype(
        np.complex64)
    close(ti(torch.from_numpy(c)), np.asarray(ji(jnp.asarray(c))), 1e-5)


# ----------------------------------------------------------------- SFNO --

@pytest.mark.parametrize("mlp", [False, True], ids=["plain", "channel_mlp"])
def test_sfnonet_matches_jax(mlp):
    kw = dict(n_modes=(4, 4), hidden_channels=4, in_channels=3, out_channels=2, lifting_channels=6,
              projection_channels=6, n_layers=2, img_size=(8, 16), use_mlp=mlp)
    jm = psci.arch.SFNONet(("a",), ("u",), rngs=Rngs(9), **kw)
    tm = tsfno.SFNONet(("a",), ("u",), device="cpu", **kw)
    x = np.random.default_rng(10).standard_normal((2, 3, 8, 16)).astype(np.float32)
    arch_parity(jm, tm, {"a": x})


def test_spherical_swe_dataset_is_bitwise_the_jax_packages():
    from paddlescience_tpu.data.dataset.domain_dataset import SphericalSWEDataset as JSWE

    for split in ("train", "test"):
        j = JSWE(("x",), ("y",), data_split=split, num_samples=3, H=8, W=16)
        t = tdd.SphericalSWEDataset(("x",), ("y",), data_split=split, num_samples=3, H=8, W=16)
        assert np.array_equal(t.input["x"], j.input["x"]) and np.array_equal(t.label["y"], j.label["y"])


def test_sfno_swe_three_train_steps_match_jax(tmp_path):
    js = jswe.build_solver(epochs=2, output_dir=str(tmp_path / "jax"))
    ts = tswe.build_solver(epochs=2, output_dir=str(tmp_path / "port"), shuffle=False, device="cpu")
    three_steps(js, ts)
    j_metric, _ = js.eval()
    t_metric, _ = ts.eval()
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-4)
