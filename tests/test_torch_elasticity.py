"""The port's control_arm example against paddlescience_tpu on the CPU:
forward and inverse (a Mesh with sdf-weighted residuals; the inverse on
frozen networks with the Lame fields of two more). ``test_torch_bracket.py``
holds the bracket example the same way, with the helpers of this file.

Each JAX example is built as it stands, its networks cut by wrapping
``psci.arch.MLP`` (control_arm: 3 x 32, 256 interior and 32 boundary
points, one iteration's worth, as ``test_torch_aneurysm.py`` cuts the
aneurysm); the port's builder gets the same sizes; both sample bitwise the
same points from one seed (the JAX mesh code pinned to its numpy branch,
the port's on its C++ ray cast, whose hit counts are the numpy ones: the
sdf column agrees within 1e-6). From the same weights, three train steps
give the same losses within 1e-4 relative; then one inverse step, with
the frozen networks bitwise unchanged.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddlescience_tpu as psci
from paddlescience_tpu import native as jnative
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import control_arm as tarm
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import control_arm as jarm  # noqa: E402  (the JAX example)

STEPS, LR = 3, 1e-3
ARM = dict(n_interior=256, n_bc=32)
WIDTH, LAYERS = 32, 3


@pytest.fixture(autouse=True)
def _numpy_mesh_highest_precision(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _jax_steps(js, steps, deriv="jet"):
    """Per-constraint losses of ``steps`` jitted steps on one host batch."""
    names = list(js.constraint)
    out = []
    with jpath.override(jpath.CANDIDATES[deriv]):
        step_fn = js._build_train_step()
        host = {n: jax.tree.map(jnp.asarray, next(js.constraint[n].data_iter)) for n in names}
        for _ in range(steps):
            js.state, logs = step_fn(js.state, host)
            out.append([float(logs["loss"])] + [float(logs[f"loss/{n}"]) for n in names])
    return host, out


def _port_steps(ts, steps):
    out = []
    for _ in range(steps):
        logs = ts.train_step()
        out.append([float(logs["loss"])] + [float(logs[f"loss/{n}"]) for n in ts.constraint])
    return out


def _same_batches(ts, host, sdf_rtol=0.0):
    for n in host:
        for j_part, t_part in zip(host[n], ts._static_batches[n]):
            assert set(j_part) == set(t_part), n
            for k in j_part:
                got, ref = t_part[k].numpy(), np.asarray(j_part[k])
                if k == "sdf" and sdf_rtol:
                    np.testing.assert_allclose(got, ref, rtol=sdf_rtol, atol=sdf_rtol * np.abs(ref).max())
                else:
                    np.testing.assert_array_equal(got, ref, err_msg=f"{n} {k}")


@pytest.fixture()
def arm(tmp_path, monkeypatch):
    """The JAX and port forward solvers at the cut sizes on one STL, the
    port's weights loaded from the JAX solver's."""
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, LAYERS, WIDTH, **kw))
    stl = tarm.write_arm_stl(str(tmp_path / "control_arm.stl"))
    js, jgeom = jarm.build_forward(epochs=1, iters_per_epoch=1, output_dir=str(tmp_path / "jax"), geom_path=stl,
                                   **ARM)
    ts, tgeom = tarm.build_forward(epochs=1, iters_per_epoch=1, output_dir=None, geom_path=stl, width=WIDTH,
                                   num_layers=LAYERS, device="cpu", deriv="jet_pallas_full", **ARM)
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    return js, jgeom, ts, tgeom


def test_control_arm_forward_and_inverse_steps_match_jax(arm, tmp_path):
    js, jgeom, ts, tgeom = arm
    assert list(ts.constraint) == list(js.constraint) == ["BC_LEFT", "BC_RIGHT", "BC_SURFACE", "INTERIOR"]
    assert ts.models[0].jet_segment_lengths() == [LAYERS]
    host, j_losses = _jax_steps(js, STEPS, "jet_pallas_full")
    _same_batches(ts, host, sdf_rtol=1e-6)
    np.testing.assert_allclose(_port_steps(ts, STEPS), j_losses, rtol=1e-4)

    # the inverse problem: both draw its points from the host stream where the forward left it
    state = np.random.get_state()
    inv = jarm.build_inverse(js, jgeom, epochs=1, iters_per_epoch=1, output_dir=str(tmp_path / "jinv"),
                             n_interior=ARM["n_interior"])
    np.random.set_state(state)
    tinv = tarm.build_inverse(ts, tgeom, epochs=1, iters_per_epoch=1, output_dir=None,
                              n_interior=ARM["n_interior"])
    assert [m.frozen for m in tinv.models] == [True, True, False, False]
    load_jax_params(tinv.model, flatten_tree(jax.tree.map(np.asarray, inv.state["params"])))
    frozen0 = {n: p.detach().clone() for n, p in tinv.model.named_parameters() if not p.requires_grad}
    live0 = {n: p.detach().clone() for n, p in tinv.model.named_parameters() if p.requires_grad}
    assert frozen0 and all(n.startswith(("model_list.0.", "model_list.1.")) for n in frozen0)
    host, j_inv = _jax_steps(inv, 1, "jet_pallas_full")
    _same_batches(tinv, host, sdf_rtol=1e-6)
    np.testing.assert_allclose(_port_steps(tinv, 1), j_inv, rtol=1e-4)
    j_params = flatten_tree(jax.tree.map(np.asarray, inv.state["params"]))
    for n, p in tinv.model.named_parameters():
        if n in frozen0:
            np.testing.assert_array_equal(p.detach().numpy(), frozen0[n].numpy(), err_msg=n)
        else:
            assert not np.array_equal(p.detach().numpy(), live0[n].numpy()), n
            np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=1e-4, atol=1e-2 * LR, err_msg=n)

    # the validator: the same 512 points, and the same L2Rel of lambda_ and mu
    j_metric, j_group = inv.eval()
    t_metric, t_group = tinv.eval()
    assert set(t_group["elasticity"]) == set(j_group["elasticity"]) == {"L2Rel.lambda_", "L2Rel.mu"}
    for k, v in j_group["elasticity"].items():
        np.testing.assert_allclose(t_group["elasticity"][k], v, rtol=1e-4, err_msg=k)
