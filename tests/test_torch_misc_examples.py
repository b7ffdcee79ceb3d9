"""The port's solver examples of the recurrent, misc and generative slice
against paddlescience_tpu on the CPU: epnn_elastoplastic, phygeonet and
phygeonet_bc (on a 12 x 16 annulus; the meshes and the Jacobi reference
bitwise at the examples' 19 x 84), iops and regae (JAX's eps passed in):
each example's data bitwise the JAX example's, then three train steps of
the JAX solver's compiled step (``_earthformer_parity.py``;
shuffle off on both sides) and of the port's from the same parameters:
losses within 1e-4, the parameters after them within 1e-4 of the largest
magnitude (``_misc_parity.py``). JAX networks are built from numpy draws,
and the widths are cut as each test says. chip_heat is in
``test_torch_chip_heat.py``, transformer4sr in
``test_torch_transformer4sr.py``, the hand loops in
``test_torch_misc_loops.py`` (tempogan_lite's in ``test_torch_tempogan.py``)."""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from _earthformer_parity import numpy_init, one_torch_thread  # noqa: F401
from _misc_parity import solver_steps
from _operator_parity import highest_precision  # noqa: F401
from paddlescience_torch.examples import epnn_elastoplastic as tepnn
from paddlescience_torch.examples import iops as tiops
from paddlescience_torch.examples import phygeonet as tgeo
from paddlescience_torch.examples import regae as tregae

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import epnn_elastoplastic as jepnn  # noqa: E402  (the JAX examples)
import iops as jiops  # noqa: E402
import phygeonet as jgeo  # noqa: E402
import regae as jregae  # noqa: E402


def test_epnn_three_steps_match_jax(tmp_path):
    jin, jlab = jepnn._synthetic_paths()
    tin, tlab = tepnn.synthetic_paths()
    assert np.array_equal(jin["state"], tin["state"]) and np.array_equal(jlab["dstress"], tlab["dstress"])
    with numpy_init():
        js = jepnn.build_solver(epochs=1, output_dir=str(tmp_path))
    solver_steps(js, tepnn.build_solver(epochs=1, output_dir=None, device="cpu"))


def test_phygeonet_meshes_and_reference_match_jax():
    for jm, tm in ((jgeo._annulus_mesh(), tgeo.annulus_mesh()), (jgeo._full_annulus_mesh(), tgeo.full_annulus_mesh())):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            assert jm[k].dtype == tm[k].dtype and np.array_equal(jm[k], tm[k]), k
    data = tgeo.annulus_mesh()
    assert np.array_equal(jgeo.jacobi_reference(data, iters=50), tgeo.jacobi_reference(data, iters=50))


@pytest.mark.parametrize("variant", ["quarter", "bc"])
def test_phygeonet_three_steps_match_jax(variant, tmp_path, monkeypatch):
    small = dict(ny=12, nx=16)  # the examples' 19 x 84 annulus cut
    monkeypatch.setattr(jgeo, "load_data", lambda d: jgeo._annulus_mesh(**small))
    monkeypatch.setattr(jgeo, "_full_annulus_mesh", functools.partial(jgeo._full_annulus_mesh, **small))
    monkeypatch.setattr(tgeo, "load_data", lambda d: tgeo.annulus_mesh(**small))
    monkeypatch.setattr(tgeo, "full_annulus_mesh", functools.partial(tgeo.full_annulus_mesh, **small))
    kw = dict(epochs=1, hidden=(4, 8, 4))
    jbuild, tbuild = ((jgeo.build_solver, tgeo.build_solver) if variant == "quarter"
                      else (jgeo.build_solver_bc, tgeo.build_solver_bc))
    with numpy_init():
        js, _ = jbuild(output_dir=str(tmp_path), **kw)
    ts, _ = tbuild(output_dir=None, device="cpu", **kw)
    solver_steps(js, ts)


def test_iops_three_steps_match_jax(tmp_path):
    assert all(np.array_equal(a, b) for a, b in zip(jiops.synth_pollution(), tiops.synth_pollution()))
    with numpy_init():
        js = jiops.build_solver(epochs=1, output_dir=str(tmp_path), data_path=None)
    solver_steps(js, tiops.build_solver(epochs=1, output_dir=None, data_path=None, device="cpu"))


def test_regae_three_steps_match_jax_with_its_eps(tmp_path):
    assert np.array_equal(jregae.synth_fields(8, seed=2), tregae.synth_fields(8, seed=2))
    kw = dict(epochs=1, batch_size=16, latent_dim=4, hidden_dim=16)
    with numpy_init():
        js = jregae.build_solver(output_dir=str(tmp_path), **kw)
    ts = tregae.build_solver(output_dir=None, device="cpu", **kw)
    ts.model.set_noise(torch.from_numpy(np.array(jax.random.normal(js.model._rng, (16, 4)))))  # JAX's draw
    solver_steps(js, ts)


