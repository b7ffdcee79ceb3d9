"""The port's D2Q9 lattice-Boltzmann step and cavity run
(paddlescience_torch/ops/lbm.py) against the JAX package's plain reference
(paddlescience_tpu/ops/lbm.py::lbm_step_reference, run_cavity with
use_pallas=False) on the CPU. The JAX package's Pallas kernel has no CPU
mode (VMEM block specs, no interpret flag), so the reference is its plain
version; the port's CUDA kernel is held against the port's plain version
on the card (tests/test_torch_jet_mlp_kernels.py, chip_smoke.py).

Tolerance: 1e-5 absolute on distributions and fields of order 0.1 to 1
(float32 sums in another order, 1/tau against a division).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_tpu.ops import lbm as jlbm
from paddlescience_torch.ops import lbm as tlbm

ATOL = 1e-5
SHAPES = [(32, 32), (24, 40)]  # (ny, nx)


def test_lattice_constants_match():
    np.testing.assert_array_equal(np.array(tlbm.D2Q9_E), jlbm.D2Q9_E)
    np.testing.assert_allclose(np.array(tlbm.D2Q9_W, np.float32), jlbm.D2Q9_W, rtol=1e-7)
    np.testing.assert_array_equal(np.array(tlbm._OPP), jlbm._OPP)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_lbm_step_plain_matches_reference(ny, nx):
    """One step from a perturbed lattice (every direction and wall in play)."""
    rng = np.random.default_rng(0)
    rho = 1.0 + 0.05 * rng.standard_normal((ny, nx))
    ux, uy = 0.05 * rng.standard_normal((2, ny, nx))
    f0 = np.asarray(jlbm._equilibrium(jnp.asarray(rho, jnp.float32), jnp.asarray(ux, jnp.float32),
                                      jnp.asarray(uy, jnp.float32)))
    f0 = (f0 * (1.0 + 0.01 * rng.standard_normal(f0.shape))).astype(np.float32)
    ref = np.asarray(jlbm.lbm_step_reference(jnp.asarray(f0), 0.62, 0.1))
    got = tlbm.lbm_step_plain(torch.from_numpy(f0), 0.62, 0.1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # the CPU wrapper is the plain version and counts no launch
    tlbm.reset_counters()
    via_wrapper = tlbm.lbm_step(torch.from_numpy(f0), 0.62, 0.1)
    np.testing.assert_array_equal(via_wrapper.numpy(), got.numpy())
    assert tlbm.lbm_collide_stream.launches == 0 and tlbm.lbm_collide_stream_plain.cuda_calls == 0


@pytest.mark.parametrize("steps", [1, 100])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_run_cavity_matches_reference(ny, nx, steps):
    ref = jlbm.run_cavity(nx=nx, ny=ny, re=100.0, u_lid=0.1, steps=steps)
    got = tlbm.run_cavity(nx=nx, ny=ny, re=100.0, u_lid=0.1, steps=steps, device="cpu")
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (ny, nx)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)


def test_cavity_physics():
    """The checks of the JAX package's own cavity test: finite fields, mass
    kept, the lid drags the fluid in +x."""
    rho, ux, uy = tlbm.run_cavity(nx=32, ny=32, re=100.0, u_lid=0.1, steps=100, device="cpu")
    assert tuple(rho.shape) == (32, 32)
    assert bool(torch.isfinite(ux).all()) and bool(torch.isfinite(uy).all())
    assert float(rho.mean()) == pytest.approx(1.0, abs=0.05)
    assert float(ux[-2].mean()) > 0.01


def test_lbm_step_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError, match="CUDA"):
        tlbm.lbm_step(torch.empty(9, 4, 4, device="meta"), 0.6, 0.1)
    with pytest.raises(ValueError, match=r"\(9, H, W\)"):
        tlbm.lbm_step(torch.zeros(8, 4, 4), 0.6, 0.1)


def test_run_cavity_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlbm.run_cavity(nx=8, ny=8, steps=1)
