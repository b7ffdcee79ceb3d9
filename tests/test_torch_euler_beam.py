"""The port's euler_beam example against the JAX example on the CPU.

``paddlescience_torch.examples.euler_beam.build_solver`` and
``examples/euler_beam.py::build_solver`` at one iteration per epoch (the
TIPC shape: 100 Hammersley interior points, 4 evenly spaced boundary
points), the JAX model's weights loaded into the port's. Checked: the
constraint batches bitwise; the boundary derivatives u', u'', u''' and
the fourth-order biharmonic residual within 1e-5 (relative to the largest
magnitude), on the jet path, on the MLP kernels' path (their plain
versions here) and under the ``jvp`` candidate; three train steps against
the JAX solver's jitted step (losses 1e-4 relative, learning rates,
parameters within 1e-2 lr); the L2Rel eval within 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.solver.solver import _convert_expr
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import euler_beam as teb
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import euler_beam as jeb  # noqa: E402  (the JAX example)

LR, STEPS = 1e-3, 3


@pytest.fixture(autouse=True)
def _float32_and_paths(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _solvers(tmp_path, deriv="jet_pallas_full"):
    js = jeb.build_solver(epochs=1, iters_per_epoch=1, output_dir=str(tmp_path / "jax"))
    ts = teb.build_solver(epochs=1, iters_per_epoch=1, output_dir=str(tmp_path / "port"), deriv=deriv, device="cpu")
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    return js, ts


def test_constraint_batches_bitwise(tmp_path):
    js, ts = _solvers(tmp_path)
    assert list(ts.constraint) == list(js.constraint) == ["EQ", "BC"]
    for name in js.constraint:
        jd, td = js.constraint[name].dataset, ts.constraint[name].dataset
        for part in ("input", "label"):
            a, b = getattr(jd, part), getattr(td, part)
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, part, k)
    x = ts.constraint["BC"].dataset.input["x"]
    assert x.ravel().tolist() == [0.0, 0.0, 1.0, 1.0] and x.dtype == np.float32
    assert ts.constraint["EQ"].dataset.input["x"].shape == (100, 1)


@pytest.mark.parametrize("deriv", ["jet", "jet_pallas_full", "jvp"])
def test_boundary_derivatives_and_residual_match_jax(tmp_path, deriv):
    """u(0), u'(0), u''(1), u'''(1) and the residual u'''' + 1 at the
    interior points: the orders above 2 by nested jvp in both packages."""
    js, ts = _solvers(tmp_path, deriv)
    for name in ("BC", "EQ"):
        jinp = {k: jnp.asarray(v) for k, v in js.constraint[name].dataset.input.items()}
        tinp = {k: torch.from_numpy(v) for k, v in ts.constraint[name].dataset.input.items()}
        with jpath.override(jpath.CANDIDATES["jet"]):
            jr = jexpr.evaluate_expressions([js.model], jinp, _convert_expr(js.constraint[name].output_expr))
        with tpath.override(tpath.CANDIDATES[deriv]):
            tr = texpr.evaluate_expressions([ts.model], tinp, ts.constraint[name].output_expr)
        for k in ts.constraint[name].output_keys:
            _close(tr[k], jr[k], 1e-5)
    assert tr["biharmonic"].shape == (100, 1)


def test_three_train_steps_match_jax_solver(tmp_path):
    js, ts = _solvers(tmp_path)
    j_losses = []
    with jpath.override(jpath.CANDIDATES["jet"]):
        step_fn = js._build_train_step()
        for _ in range(STEPS):
            host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
            js.state, logs = step_fn(js.state, host)
            j_losses.append([float(logs[k]) for k in ("loss", "loss/EQ", "loss/BC", "lr")])
    t_losses = []
    for _ in range(STEPS):
        logs = ts.train_step()
        t_losses.append([float(logs[k]) for k in ("loss", "loss/EQ", "loss/BC", "lr")])
    np.testing.assert_allclose(np.array(t_losses), np.array(j_losses), rtol=1e-4)
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    diffs = np.concatenate([np.abs(p.detach().numpy() - j_params[n]).ravel() for n, p in ts.model.named_parameters()])
    assert diffs.max() <= 1e-2 * LR


def test_l2rel_eval_matches_jax(tmp_path):
    js, ts = _solvers(tmp_path)
    j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert list(t_group) == list(j_group) == ["L2Rel_Metric"]
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-5)
    assert set(t_group["L2Rel_Metric"]) == {"L2Rel.u"}


def test_trains_under_the_jvp_candidate(tmp_path):
    """With no jet at all (every derivative by nested jvp) the solver takes
    the same steps as on the jet path."""
    runs = {}
    for deriv in ("jet", "jvp"):
        ts = teb.build_solver(epochs=1, iters_per_epoch=2, output_dir=None, deriv=deriv, device="cpu")
        runs[deriv] = [float(ts.train_step()["loss"]) for _ in range(2)]
    np.testing.assert_allclose(runs["jvp"], runs["jet"], rtol=1e-5)
