"""The port's ``Laplace`` and its laplace2d and ldc2d_steady examples against
paddlescience_tpu on the CPU.

``Laplace(dim)`` in closure form against the JAX package's sympy form: the
residual within 1e-5 and its parameter gradient within 1e-4 (relative to
the largest magnitude) on 256 points, in 2-D and 3-D. Each example built at
the JAX example's defaults, the JAX model's weights loaded into the
port's: the constraint batches bitwise, three train steps against the JAX
solver's jitted step (losses and learning rates within 1e-4), the eval
within 1e-5; the ldc2d L-BFGS branch builds the example's L-BFGS.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.solver.solver import _convert_expr
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch.arch.mlp import MLP as TMLP
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.equation.pde.basic import Laplace as TLaplace
from paddlescience_torch.examples import laplace2d as tlaplace
from paddlescience_torch.examples import ldc2d_steady as tldc
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import laplace2d as jlaplace  # noqa: E402  (the JAX examples)
import ldc2d_steady as jldc  # noqa: E402

STEPS = 3


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("deriv", ["jet", "jvp"])
def test_laplace_residual_and_gradient_match_jax(dim, deriv):
    keys = ("x", "y", "z")[:dim]
    jm = psci.arch.MLP(keys, ("u",), 3, 24, rngs=Rngs(dim))
    tm = TMLP(keys, ("u",), 3, 24, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    rng = np.random.default_rng(dim)
    pts = {k: rng.uniform(-1, 1, (256, 1)).astype(np.float32) for k in keys}
    jexprs = _convert_expr(psci.equation.Laplace(dim=dim).equations)
    texprs = TLaplace(dim=dim).equations
    assert list(texprs) == list(jexprs) == ["laplace"]
    params, rest = jm.param_tree(), jm.buffer_tree()

    def loss(p):
        with jm.bind(p, rest):
            r = jexpr.evaluate_expressions([jm], {k: jnp.asarray(v) for k, v in pts.items()}, jexprs)["laplace"]
        return jnp.mean(r**2), r

    with jpath.override(jpath.CANDIDATES["jet"]):
        (_, j_res), j_grads = jax.value_and_grad(loss, has_aux=True)(params)
    with tpath.override(tpath.CANDIDATES[deriv]):
        t_res = texpr.evaluate_expressions([tm], {k: torch.from_numpy(v) for k, v in pts.items()}, texprs)["laplace"]
    _close(t_res, j_res, 1e-5)
    grads = torch.autograd.grad((t_res**2).mean(), list(tm.parameters()), allow_unused=True)
    j_grads = flatten_tree(jax.tree.map(np.asarray, j_grads))
    for (n, p), g in zip(tm.named_parameters(), grads):
        _close(torch.zeros_like(p) if g is None else g, j_grads[n], 1e-4)


def _assert_same_batches(js, ts):
    assert list(ts.constraint) == list(js.constraint)
    for name in js.constraint:
        jd, td = js.constraint[name].dataset, ts.constraint[name].dataset
        for part in ("input", "label", "weight"):
            a, b = getattr(jd, part) or {}, getattr(td, part) or {}
            assert list(a) == list(b), (name, part)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, part, k)


def _three_steps(js, ts, names):
    j_losses = []
    with jpath.override(jpath.CANDIDATES["jet"]):
        step_fn = js._build_train_step()
        for _ in range(STEPS):
            host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
            js.state, logs = step_fn(js.state, host)
            j_losses.append([float(logs[k]) for k in names])
    t_losses = []
    for _ in range(STEPS):
        logs = ts.train_step()
        t_losses.append([float(logs[k]) for k in names])
    np.testing.assert_allclose(np.array(t_losses), np.array(j_losses), rtol=1e-4)
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    for n, p in ts.model.named_parameters():
        assert np.abs(p.detach().numpy() - j_params[n]).max() <= 1e-2 * 1e-3, n


def _laplace(tmp_path):
    js = jlaplace.build_solver(output_dir=str(tmp_path / "jax"))
    ts = tlaplace.build_solver(output_dir=str(tmp_path / "port"), device="cpu")
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    return js, ts


def _ldc(tmp_path):
    js = jldc.build_solver(output_dir=str(tmp_path / "jax"))
    ts = tldc.build_solver(output_dir=str(tmp_path / "port"), device="cpu")
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    return js, ts


def test_laplace2d_batches_and_three_steps_match_jax(tmp_path):
    js, ts = _laplace(tmp_path)
    _assert_same_batches(js, ts)
    assert ts.constraint["EQ"].dataset.input["x"].shape == (99**2 + 400, 1)
    assert ts.epochs == 20 and ts.iters_per_epoch == 1 and tpath.get_default() == {}
    _three_steps(js, ts, ("loss", "loss/EQ", "loss/BC", "lr"))


def test_laplace2d_eval_matches_jax(tmp_path):
    js, ts = _laplace(tmp_path)
    j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert list(t_group) == list(j_group) == ["MSE_Metric"] and set(t_group["MSE_Metric"]) == {"MSE.u"}
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-5)


def test_ldc2d_steady_batches_and_three_steps_match_jax(tmp_path):
    js, ts = _ldc(tmp_path)
    _assert_same_batches(js, ts)
    shapes = {n: c.dataset.input["x"].shape[0] for n, c in ts.constraint.items()}
    # batch_size x iters_per_epoch points each, fed whole every step, as the JAX example samples them
    assert shapes == {"EQ": 2048 * 50, "BC_top": 256 * 50, "BC_rest": 768 * 50}
    _three_steps(js, ts, ("loss", "loss/EQ", "loss/BC_top", "loss/BC_rest", "lr"))


def test_ldc2d_steady_eval_matches_jax(tmp_path):
    js, ts = _ldc(tmp_path)
    with jpath.override(jpath.CANDIDATES["jet"]):
        j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert list(t_group) == list(j_group) == ["residual"]
    assert set(t_group["residual"]) == {"MSE.continuity", "MSE.momentum_x", "MSE.momentum_y"}
    for k, v in j_group["residual"].items():
        np.testing.assert_allclose(t_group["residual"][k], float(v), rtol=1e-5)
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-5)


def test_ldc2d_steady_lbfgs_builds_the_example_lbfgs():
    """``lbfgs=True`` builds the JAX example's ``LBFGS(max_iter=10)`` (its
    parity with JAX is in ``test_torch_lbfgs.py``)."""
    ts = tldc.build_solver(lbfgs=True, device="cpu", output_dir=None)
    opt = ts.optimizer
    assert opt.is_lbfgs and opt.linesearch.max_linesearch_steps == 10 and opt.history_size == 100
    assert opt.state["diff_params_memory"].shape == (100, sum(p.numel() for p in ts.model.parameters()))
