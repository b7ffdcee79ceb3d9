"""The port's XPINN and hPINNs hand loops against the JAX examples on the
CPU, at a cut size.

Both packages get the same parameters (``load_jax_params``) and the same
numpy points; JAX runs at "highest" matmul precision. XPINN: the loss and
its gradient on the port's default derivative path (the plain jet) and on
the ``jvp`` candidate against the JAX example's nested ``jax.jvp``
(losses 1e-5, gradients 1e-4 relative to the largest magnitude), then
three Adam steps (losses 1e-4). hPINNs: the residuals and the objective,
three steps of the inner loop, then one augmented-Lagrangian update and
three more steps (losses 1e-4). The loops' ``StepGraph``: a graph's key
holds the derivative path and cuDNN's determinism, and eager chunks hand
each step its index.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.examples import hpinns as thp
from paddlescience_torch.examples import xpinn as txp
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params
from paddlescience_torch.utils.step_graph import StepGraph, deterministic_convs, graph_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import hpinns as jhp  # noqa: E402  (the JAX examples)
import xpinn as jxp  # noqa: E402


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


class _Cfg:
    """The attribute view of a config dict that the JAX examples read."""

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, _Cfg(**v) if isinstance(v, dict) else v)


XPINN_CUT = dict(num_boundary_points=40, num_residual1_points=64, num_residual2_points=48,
                 num_residual3_points=48, num_interface=16, learning_rate=5e-4)


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def test_xpinn_points_are_the_jax_examples():
    for a, b in zip(jax.tree.leaves(txp.sample_points(10, (7, 5, 5), 4, seed=3)),
                    jax.tree.leaves(jxp.sample_points(10, (7, 5, 5), 4, seed=3))):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_xpinn():
    """The JAX example at the cut size: its initial parameters; three
    steps' losses (each step returns the loss before its update) and the
    l2_rel after them; the gradient at the initial parameters (Adam's
    first moment after one step is 0.1 x the gradient)."""
    _, params0, opt, step, l2_rel = jxp.build(_Cfg(TRAIN=dict(XPINN_CUT)), seed=42)
    params, losses = params0, []
    for i in range(3):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
        if i == 0:
            grads = {f"{k}.{n}": v / 0.1 for k, tree in enumerate(opt[0].mu)
                     for n, v in flatten_tree(jax.tree.map(np.asarray, tree)).items()}
    return dict(params0=jax.tree.map(np.asarray, params0), loss0=losses[0], grads0=grads, losses=losses,
                l2_rel=l2_rel(params))


def _xpinn_port(params):
    model = txp.build(XPINN_CUT, device="cpu")
    for net, p in zip(model.nets, params):
        load_jax_params(net, p)
    return model


@pytest.mark.parametrize("deriv", ["default", "jvp"])
def test_xpinn_loss_and_gradient_match_jax(jax_xpinn, deriv):
    model = _xpinn_port(jax_xpinn["params0"])
    flags = deriv_path.CANDIDATES["jvp"] if deriv == "jvp" else {}
    with deriv_path.override(flags):
        loss, *grads = model.gradients()
    _close(loss, jax_xpinn["loss0"], 1e-5)
    names = [f"{k}.{n}" for k, net in enumerate(model.nets) for n, _ in net.named_parameters()]
    for name, g in zip(names, grads):
        _close(g, jax_xpinn["grads0"][name], 1e-4)


def test_xpinn_three_steps_match_jax(jax_xpinn):
    model = _xpinn_port(jax_xpinn["params0"])
    t_losses = [model.train_steps(1) for _ in range(3)]
    np.testing.assert_allclose(t_losses, jax_xpinn["losses"], rtol=1e-4)
    np.testing.assert_allclose(model.l2_rel(), jax_xpinn["l2_rel"], rtol=1e-4)


HPINN_CUT = dict(num_layers=2, hidden_size=16, num_opt_points=48, num_pde_points=96, learning_rate=1e-3)


@pytest.fixture(scope="module")
def jax_hpinns():
    cfg = _Cfg(MODEL=dict(num_layers=2, hidden_size=16),
               TRAIN=dict(num_opt_points=48, num_pde_points=96, learning_rate=1e-3))
    return jhp.build(cfg, seed=42)


def _hpinn_port(params):
    model = thp.build(HPINN_CUT, device="cpu")
    for net, p in zip(model.nets, params):
        load_jax_params(net, jax.tree.map(np.asarray, p))
    return model


def test_hpinns_points_and_features_are_the_jax_examples():
    a, na = thp.sample_points(9, 11, seed=2)
    b, nb = jhp.sample_points(9, 11, seed=2)
    assert na == nb and np.array_equal(a, b)
    assert thp.IN_KEYS == tuple(f"x_cos_{t}" for t in range(1, 7)) + tuple(f"x_sin_{t}" for t in range(1, 7)) + (
        "y", "y_cos_1", "y_sin_1")


def test_hpinns_residuals_and_objective_match_jax(jax_hpinns):
    params, _, _, residuals_jit, _, _, _, loss_fn = jax_hpinns
    model = _hpinn_port(params)
    j_re, j_im = residuals_jit(params)
    t_re, t_im = model.residuals()
    _close(t_re, np.asarray(j_re), 1e-5)
    _close(t_im, np.asarray(j_im), 1e-5)
    lam = np.random.default_rng(4).standard_normal((2, len(j_re))).astype(np.float32)
    model.lam_re.copy_(torch.from_numpy(lam[0]))
    model.lam_im.copy_(torch.from_numpy(lam[1]))
    j_loss, (j_eqs, j_obj) = jax.jit(loss_fn)(params, jnp.asarray(lam[0]), jnp.asarray(lam[1]), 2.0)
    loss, eqs, obj = model.loss()
    for got, want in ((loss, j_loss), (eqs, j_eqs), (obj, j_obj)):
        _close(got, np.asarray(want), 1e-5)


def test_hpinns_augmented_lagrangian_steps_match_jax(jax_hpinns):
    """Three inner steps, the multiplier update, three more."""
    params, opt, step, residuals_jit = jax_hpinns[:4]
    model = _hpinn_port(params)
    lam_re = lam_im = jnp.zeros((96,))
    mu = 2.0
    j_logs, t_logs = [], []
    for outer in range(2):
        for _ in range(3):
            params, opt, loss, (eqs, obj) = step(params, opt, lam_re, lam_im, mu)
            j_logs.append([float(loss), float(eqs), float(obj)])
            t = model.train_steps(1)
            t_logs.append([t["loss"], t["pde"], t["obj"]])
        if outer == 0:
            res_re, res_im = residuals_jit(params)
            lam_re, lam_im, mu = lam_re + mu * res_re, lam_im + mu * res_im, mu * jhp.BETA
            model.lagrangian_update()
            assert float(model.mu) == mu
            _close(model.lam_re, np.asarray(lam_re), 1e-4)
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)


def test_step_graph_keys_hold_the_derivative_path_and_cudnn_determinism():
    saved = deriv_path.get_default()
    base = graph_key(5)
    try:
        deriv_path.set_default(deriv_path.CANDIDATES["jvp"])
        on_jvp = graph_key(5)
    finally:
        deriv_path.set_default(saved)
    assert on_jvp[0] == base[0] == 5 and on_jvp[1] == tuple(sorted(deriv_path.CANDIDATES["jvp"].items()))
    assert on_jvp != base and graph_key(5) == base
    assert graph_key(5, deriv_path.CANDIDATES["jvp"]) == on_jvp
    before = torch.backends.cudnn.deterministic
    with deterministic_convs():
        assert torch.backends.cudnn.deterministic and graph_key(5)[2] is True
    assert torch.backends.cudnn.deterministic == before and graph_key(5) == base


def test_step_graph_runs_eager_chunks_step_by_step_and_restores_its_state():
    w = torch.zeros(3)
    seen = []

    def step(i):
        seen.append(i)
        w.add_(1.0)
        return {"w0": w[0].clone()}

    loop = StepGraph(step, torch.device("cpu"), state=lambda: [w])
    snap = loop.snapshot()
    logs = loop.run(4)  # on the CPU a chunk is eager steps, graphed or not
    assert seen == [0, 1, 2, 3] and float(logs["w0"]) == 4.0 and not loop.graphs
    loop.restore(snap)
    assert torch.equal(w, torch.zeros(3))
    with pytest.raises(ValueError):
        StepGraph(step, torch.device("cpu"))
