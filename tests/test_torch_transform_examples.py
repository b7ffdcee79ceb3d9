"""The port's transform and integral-equation examples against
paddlescience_tpu on the CPU: poiseuille_flow, heat_pinn,
ldc2d_unsteady_Re10, volterra_ide, biharmonic2d, gpinn,
fractional_poisson_2d, bubble and deephpms (burgers, kdv, ks).

Each JAX example is built as it stands, its networks cut to 3 layers of
width 16 by wrapping ``psci.arch.MLP`` and its point counts cut by
wrapping the constraint classes (or by its own arguments); the port's
builder gets the same sizes. The host data are the same arrays bitwise
(bubble's shuffled loader aside: both feed the whole training set, in
their own orders, to a mean). From the same weights, three train steps
on the ``jet`` path (nested jvp for every transformed net, as in JAX)
give per-constraint losses within 1e-4 relative, and the validators'
metrics after them agree within 1e-4. deephpms runs its three stages,
three steps each, with its generators cut to a 32- or 64-point grid; the
generators' fields are the JAX example's bitwise.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest

import paddlescience_tpu as psci
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import (biharmonic2d, bubble, deephpms, fractional_poisson_2d, gpinn, heat_pinn,
                                          ldc2d_unsteady_Re10, poiseuille_flow, volterra_ide)
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

from test_torch_elasticity import _jax_steps, _port_steps, _same_batches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

STEPS, WIDTH, LAYERS = 3, 16, 3
PORT = dict(width=WIDTH, num_layers=LAYERS, device="cpu", deriv="jet")
EXAMPLES = {  # name: (port module, JAX build arguments, port build arguments, constraint batch cuts)
    "poiseuille_flow": (poiseuille_flow, {}, dict(sample_iters=1, batch_sizes=(128, 32, 16)),
                        {"EQ": 128, "WALL": 32, "PIO": 16}),
    "heat_pinn": (heat_pinn, dict(iters_per_epoch=1), dict(iters_per_epoch=1, npoint_pde=400), {"EQ": 400}),
    "ldc2d_unsteady_Re10": (ldc2d_unsteady_Re10, dict(npoint_pde=100, ntime_all=4),
                            dict(npoint_pde=100, ntime_all=4), {}),
    "volterra_ide": (volterra_ide, {}, {}, {}),
    "biharmonic2d": (biharmonic2d, {}, dict(sample_iters=1, batch_size=64), {"EQ": 64}),
    "gpinn": (gpinn, {}, {}, {}),
    "fractional_poisson_2d": (fractional_poisson_2d, dict(n_interior=40, n_r=10), dict(n_interior=40, n_r=10), {}),
    "bubble": (bubble, dict(pde_batch=256, sup_batch=4725), dict(pde_batch=256, sup_batch=4725), {}),
}
METRICS = {"ldc2d_unsteady_Re10": "residual", "volterra_ide": "u_val", "gpinn": "L2Rel",
           "fractional_poisson_2d": "L2Rel", "bubble": "bubble_mse"}


@pytest.fixture(autouse=True)
def _highest_precision():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _cut(cls, sizes):
    """The constraint class with the named constraints' batch sizes cut to
    ``sizes`` and one iteration's points."""

    def build(*args, **kw):
        if kw.get("name") in sizes:
            args = list(args)
            args[3] = {**args[3], "batch_size": sizes[kw["name"]], "iters_per_epoch": 1}
        return cls(*args, **kw)

    return build


def _cut_nets(monkeypatch):
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, LAYERS, WIDTH, **kw))


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_three_train_steps_match_jax(name, tmp_path, monkeypatch):
    module, jax_kw, port_kw, sizes = EXAMPLES[name]
    _cut_nets(monkeypatch)
    for cls in ("InteriorConstraint", "BoundaryConstraint"):
        monkeypatch.setattr(psci.constraint, cls, _cut(getattr(psci.constraint, cls), sizes))
    jmod = __import__(name)
    js = jmod.build_solver(epochs=1, output_dir=str(tmp_path / "jax"), **jax_kw)
    ts = module.build_solver(epochs=1, output_dir=None, **port_kw, **PORT)
    assert list(ts.constraint) == list(js.constraint)
    transformed = [m.has_transform for m in ts.models]
    assert [not m.supports_jet() for m in ts.models] == transformed
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    host, j_losses = _jax_steps(js, STEPS, "jet")
    _same_batches(ts, {n: v for n, v in host.items() if n in ts._static_batches})
    np.testing.assert_allclose(_port_steps(ts, STEPS), j_losses, rtol=1e-4)
    if name in METRICS:
        j_group, t_group = js.eval()[1][METRICS[name]], ts.eval()[1][METRICS[name]]
        assert set(t_group) == set(j_group)
        for k, v in j_group.items():
            np.testing.assert_allclose(t_group[k], v, rtol=1e-4, err_msg=k)


def test_transformed_examples_take_nested_jvp_and_the_matrices_sit_on_the_device():
    """The transformed nets have no jet (the autotuner offers ``jvp``
    alone where every net is transformed), the untransformed ones keep
    theirs, and the quadrature matrices were built on the solver's device."""
    from paddlescience_torch.solver import autotune

    for module, kw in ((biharmonic2d, dict(sample_iters=1, batch_size=16)), (gpinn, {}),
                       (fractional_poisson_2d, dict(n_interior=8, n_r=4))):
        ts = module.build_solver(epochs=1, output_dir=None, device="cpu", **kw)
        assert autotune.candidate_names(ts) == ["jvp"]
        if module is fractional_poisson_2d:
            assert ts.equation["fpde"]._int_mat.device == ts.device
    ts = bubble.build_solver(epochs=1, output_dir=None, device="cpu", pde_batch=16)
    assert [m.supports_jet() for m in ts.models] == [False, True, True]
    assert autotune.candidate_names(ts) == ["jvp", "jet"]
    from paddlescience_torch.equation import Volterra

    ts = volterra_ide.build_solver(epochs=1, output_dir=None, device="cpu")
    closure = ts.constraint["EQ"].output_expr["volterra"].__closure__
    (eq,) = [c.cell_contents for c in closure if isinstance(c.cell_contents, Volterra)]
    assert eq._int_mat.device == ts.device and eq._int_mat.shape == (12, 252)
    assert poiseuille_flow.build_solver(epochs=1, output_dir=None, device="cpu", sample_iters=1,
                                        batch_sizes=(8, 8, 8)).models[0].supports_jet()


def test_bubble_trains_on_its_short_last_batch():
    """The example's 2419-point batches leave a 2306-point one (drop_last
    False): eager steps take both, as the JAX solver retraces."""
    ts = bubble.build_solver(epochs=1, output_dir=None, device="cpu", width=8, num_layers=2, pde_batch=64)
    for _ in range(3):
        assert np.isfinite(float(ts.train_step()["loss"]))
    assert ts._chunk_bufs[("Sup", 1)][0]["x"].shape[1] in (2419, 2306)


def test_references_are_the_jax_examples():
    import bubble as jbubble
    import deephpms as jdeephpms
    import heat_pinn as jheat

    np.testing.assert_array_equal(heat_pinn.fdm_solve(12, iters=300), jheat.fdm_solve(12, iters=300))
    for k, v in jbubble._synthetic_bubble().items():
        np.testing.assert_array_equal(bubble.synthetic_bubble()[k], v, err_msg=k)
    for got, ref in zip(deephpms.spectral_burgers(nx=32, nt=11), jdeephpms.spectral_burgers(nx=32, nt=11)):
        np.testing.assert_array_equal(got, ref)


def _short_pdes(module, monkeypatch):
    """The generators on a 64-point (Burgers: 32 points blow up) or 32-point
    grid and, for KdV and KS, 0.4 / 0.5 time units (400 / 200 ETDRK4 steps)."""
    monkeypatch.setattr(module, "spectral_burgers", functools.partial(module.spectral_burgers, nx=64, nt=51))
    monkeypatch.setattr(module, "spectral_etdrk4", functools.partial(module.spectral_etdrk4, nx=32, nt=21))
    monkeypatch.setitem(module.PDES, "kdv", dict(module.PDES["kdv"], t=(0.0, 0.4)))
    monkeypatch.setitem(module.PDES, "ks", dict(module.PDES["ks"], t=(0.0, 0.5)))


@pytest.mark.parametrize("pde", ["burgers", "kdv", "ks"])
def test_deephpms_stages_match_jax(pde, tmp_path, monkeypatch):
    """Each stage's three steps and its validator's metric against the JAX
    ``run``, whose solvers' ``train`` is replaced by three jitted steps on
    its (whole-dataset) batch."""
    import deephpms as jdeephpms

    _short_pdes(jdeephpms, monkeypatch)
    _short_pdes(deephpms, monkeypatch)
    monkeypatch.setattr(jdeephpms, "load_data", functools.partial(jdeephpms.load_data, n_train=200))
    inits = []
    mlp = psci.arch.MLP

    def record(i, o, n, w, **kw):
        m = mlp(i, o, LAYERS, WIDTH, **kw)
        inits.append(flatten_tree(jax.tree.map(np.asarray, m.param_tree())))
        return m

    monkeypatch.setattr(psci.arch, "MLP", record)
    j_losses = []

    def jax_train(self, num_fused_steps=None):
        j_losses.append(_jax_steps(self, STEPS, "jet")[1])
        self._sync_module()

    j_metrics = []
    j_eval = psci.solver.Solver.eval

    def jax_eval(self, *args, **kw):
        out = j_eval(self, *args, **kw)
        j_metrics.append(out[0])
        return out

    monkeypatch.setattr(psci.solver.Solver, "train", jax_train)
    monkeypatch.setattr(psci.solver.Solver, "eval", jax_eval)
    j_metric = jdeephpms.run(epochs=(1, 1, 1), output_dir=str(tmp_path / "jax"), pde=pde)

    t_losses, t_metrics = [], []
    gen = deephpms.stages((1, 1, 1), output_dir=None, pde=pde, n_train=200, width=WIDTH, num_layers=LAYERS, pde_width=WIDTH,
                          pde_layers=LAYERS, device="cpu", deriv="jet")
    ts = next(gen)
    load_jax_params(ts.models[0], inits[0])
    for i in range(3):
        if i:
            ts = next(gen)
        if i == 1:
            load_jax_params(ts.models[1], inits[1])
        if i == 2:
            load_jax_params(ts.models[0], inits[2])
        t_losses.append(_port_steps(ts, STEPS))
        t_metrics.append(ts.eval()[0])
    for t, j in zip(t_losses, j_losses):
        np.testing.assert_allclose(t, j, rtol=1e-4)
    np.testing.assert_allclose(t_metrics, j_metrics, rtol=1e-4)
    assert j_metrics[-1] == j_metric and np.isfinite(t_metrics).all()


def test_gpinn_third_order_comes_from_the_tape_without_a_jet():
    """``PDE.d`` serves u_xxx of the transformed net from its stack's
    nested jvp (the stack has no jet), equal to the composed jvp of the
    transformed call."""
    import torch

    from paddlescience_torch.autodiff import ad
    from paddlescience_torch.utils import expression

    ts = gpinn.build_solver(epochs=1, output_dir=None, device="cpu", width=8, num_layers=2)
    model, eq = ts.models[0], ts.equation["gPINN"]
    x = torch.linspace(0.1, 3.0, 7).reshape(-1, 1)
    with ad.tape_context() as tape:
        out = expression.forward_with_derivatives([model], {"x": x}, tape)
        u_xxx = eq.d(ad.wrap_tape_outputs(tape, out), "u", "x", "x", "x")
        stack = tape._stacks[0]
        assert stack.jet_fn is None and (0, 0, 0) in stack._components
    f = lambda v: model({"x": v})["u"]
    ones = torch.ones_like(x)
    d1 = lambda v: torch.func.jvp(f, (v,), (ones,))[1]
    d2 = lambda v: torch.func.jvp(d1, (v,), (ones,))[1]
    ref = torch.func.jvp(d2, (x,), (ones,))[1]
    np.testing.assert_allclose(ad.unwrap(u_xxx).detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-6)
