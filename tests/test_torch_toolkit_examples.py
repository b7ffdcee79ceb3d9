"""The PINN-toolkit examples (nsfnet nets 1 and 3, darcy2d, quick_start cases
1-3, spinn_helmholtz3d, deephpms_ns, deephpms_schrodinger) and SPINN
against paddlescience_tpu on the CPU.

Each JAX example is built as it stands, its networks cut to 3 layers of
width 16 by wrapping ``psci.arch.MLP`` (nsfnet net 3 at 3 x 16 too; SPINN
at rank 4 with 2 x 16 branch nets) and its
point counts cut by its own arguments or by wrapping the constraint
classes; the port's builder gets the same sizes. From the same weights and
the same host batch, three train steps give per-constraint losses within
1e-4 relative (quick_start case 3 on Adam steps, its L-BFGS step taken
once; nsfnet net 3 on the port's ``jet_pallas_full`` segments,
their plain versions here, against the JAX ``jet`` path). SPINN's forward
and its grid derivatives (the Helmholtz residual) agree within 1e-5, with
three branch-net calls a forward and one nested jvp per component.
"""

import functools
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import (darcy2d, deephpms_ns, deephpms_schrodinger, nsfnet, quick_start,
                                          spinn_helmholtz3d)
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

from test_torch_elasticity import _jax_steps, _port_steps, _same_batches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

STEPS, WIDTH, LAYERS = 3, 16, 3
PORT = dict(width=WIDTH, num_layers=LAYERS, device="cpu")


@pytest.fixture(autouse=True)
def _highest_precision():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _cut_nets(monkeypatch):
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, LAYERS, WIDTH, **kw))


def _cut(cls, sizes):
    def build(*args, **kw):
        if kw.get("name", "EQ" if cls is psci.constraint.InteriorConstraint else "BC") in sizes:
            args = list(args)
            args[3] = {**args[3], "batch_size": sizes[kw.get("name", "EQ")], "iters_per_epoch": 1}
        return cls(*args, **kw)

    return build


def _feed_jax_batches(ts, host):
    """The port's indexed constraints take the JAX steps' host batch every
    step (a shuffled loader's order is its own)."""
    for n in ts._indexed:
        parts = tuple({k: np.asarray(v) for k, v in (part or {}).items()} for part in host[n])
        ts.constraint[n].data_iter = itertools.repeat(parts)


def _check(js, ts, deriv="jet", port_deriv="jet"):
    assert list(ts.constraint) == list(js.constraint)
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    host, j_losses = _jax_steps(js, STEPS, deriv)
    _same_batches(ts, {n: v for n, v in host.items() if n in ts._static_batches})
    _feed_jax_batches(ts, host)
    tpath.set_default(tpath.CANDIDATES[port_deriv])
    t_losses = _port_steps(ts, STEPS)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert np.isfinite(t_losses).all()
    return t_losses


@pytest.mark.parametrize("net", [1, 3])
def test_nsfnet_three_steps_match_jax(net, tmp_path, monkeypatch):
    import nsfnet as jnsfnet

    _cut_nets(monkeypatch)
    js = jnsfnet.build_solver(net=net, epochs=10, iters_per_epoch=STEPS, ntrain=128, output_dir=str(tmp_path))
    ts = nsfnet.build_solver(net=net, epochs=10, iters_per_epoch=STEPS, ntrain=128, output_dir=None, **PORT)
    if net == 3:
        assert {k: len(v[0]["x"]) for k, v in ((n, next(js.constraint[n].data_iter)) for n in ("Sup_b", "Sup_0"))} \
            == {"Sup_b": 59400, "Sup_0": 29791}
    _check(js, ts, port_deriv="jet_pallas_full" if net == 3 else "jet")
    with pytest.raises(NotImplementedError, match="cylinder_nektar_wake"):
        nsfnet.build_solver(net=2, device="cpu")


def test_darcy2d_three_steps_and_metric_match_jax(tmp_path, monkeypatch):
    import darcy2d as jdarcy

    _cut_nets(monkeypatch)
    for cls in ("InteriorConstraint", "BoundaryConstraint"):
        monkeypatch.setattr(psci.constraint, cls, _cut(getattr(psci.constraint, cls), {"EQ": 256, "BC": 64}))
    js = jdarcy.build_solver(epochs=2, output_dir=str(tmp_path))
    ts = darcy2d.build_solver(epochs=2, output_dir=None, bs_pde=256, bs_bc=64, sample_iters=1, **PORT)
    _check(js, ts)
    np.testing.assert_allclose(darcy2d.l2rel(ts), js.eval()[1]["L2Rel_Metric"]["L2Rel.p"], rtol=1e-4)


@pytest.mark.parametrize("case", [1, 2, 3])
def test_quick_start_cases_match_jax(case, tmp_path, monkeypatch):
    import quick_start as jqs

    _cut_nets(monkeypatch)
    if case == 3:  # the plate's closures against the JAX sympy forms, on Adam steps (L-BFGS is held elsewhere)
        monkeypatch.setattr(psci.optimizer, "LBFGS", lambda max_iter: psci.optimizer.Adam(1e-3))
        js = jqs.build_case3(epochs=1, output_dir=str(tmp_path), n_interior=128, n_bc=32)
        lb = quick_start.build_case3(epochs=1, output_dir=None, n_interior=128, n_bc=32, max_iter=3, **PORT)
        assert lb._lbfgs and np.isfinite(float(lb.train_step()["loss"]))
        from paddlescience_torch.optimizer import Adam
        from paddlescience_torch.solver import Solver

        ts = Solver(lb.model, lb.constraint, None, Adam(1e-3)(lb.model), epochs=1, iters_per_epoch=1,
                    equation=lb.equation, device="cpu")
        _check(js, ts)
        return
    js, _ = getattr(jqs, f"build_case{case}")(epochs=1, iters_per_epoch=STEPS, output_dir=str(tmp_path))
    ts, _ = getattr(quick_start, f"build_case{case}")(epochs=1, iters_per_epoch=STEPS, output_dir=None, **PORT)
    for n in js.constraint:
        for k, v in js.constraint[n].dataset.input.items():
            np.testing.assert_array_equal(ts.constraint[n].dataset.input[k], np.asarray(v), err_msg=f"{n} {k}")
    _check(js, ts)


def _spinn_pair(tmp_path, monkeypatch, nc=6):
    import spinn_helmholtz3d as jspinn

    spinn = psci.arch.SPINN
    monkeypatch.setattr(psci.arch, "SPINN", lambda i, o, r, num_layers, hidden_size: spinn(i, o, 4, 2, hidden_size))
    js = jspinn.build_solver(epochs=1, iters_per_epoch=STEPS, nc=nc, hidden_size=WIDTH, nc_test=5,
                             output_dir=str(tmp_path))
    ts = spinn_helmholtz3d.build_solver(epochs=1, iters_per_epoch=STEPS, nc=nc, hidden_size=WIDTH, nc_test=5,
                                        output_dir=None, r=4, num_layers=2, device="cpu")
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    rng = np.random.default_rng(3)
    coords = {k: np.sort(rng.uniform(-1, 1, (nc + i, 1)).astype(np.float32), axis=0) for i, k in enumerate("xyz")}
    q = (spinn_helmholtz3d.LAM * spinn_helmholtz3d.u_star(coords["x"][:, 0], coords["y"][:, 0], coords["z"][:, 0],
                                                          np)[..., None]).astype(np.float32)
    js.constraint["EQ"].dataset.sample_fn = lambda key: ({k: jnp.asarray(v) for k, v in coords.items()},
                                                         {"helmholtz": jnp.asarray(q)}, {})
    ts.constraint["EQ"].dataset.sample_fn = lambda g: ({k: torch.from_numpy(v) for k, v in coords.items()},
                                                       {"helmholtz": torch.from_numpy(q)}, {})
    return js, ts, coords


def test_spinn_forward_grid_derivatives_and_branch_calls(tmp_path, monkeypatch):
    from paddlescience_tpu.utils import expression as jexpr

    js, ts, coords = _spinn_pair(tmp_path, monkeypatch)
    exprs = {"u": lambda out: out["u"]}
    with js.model.bind(js.state["params"], js.state["rest"]):
        jout = jexpr.evaluate_expressions(js.models, {k: jnp.asarray(v) for k, v in coords.items()},
                                          {**exprs, "helmholtz": js.constraint["EQ"].output_expr["helmholtz"]})
    ts.model.branch_calls = 0
    tout = texpr.evaluate_expressions(ts.models, {k: torch.from_numpy(v) for k, v in coords.items()},
                                      {**exprs, "helmholtz": spinn_helmholtz3d.helmholtz})
    assert tout["u"].shape == (6, 7, 8, 1)
    assert ts.model.branch_calls == 3 * (1 + 3)  # the forward, then one nested jvp per second derivative
    for k in ("u", "helmholtz"):
        ref = np.asarray(jout[k])
        np.testing.assert_allclose(tout[k].detach().numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_spinn_helmholtz3d_three_steps_match_jax(tmp_path, monkeypatch):
    js, ts, _ = _spinn_pair(tmp_path, monkeypatch)
    j_losses = []
    step = js._build_train_step()
    for _ in range(STEPS):
        js.state, logs = step(js.state, {})
        j_losses.append(float(logs["loss"]))
    t_losses = [float(ts.train_step()["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(spinn_helmholtz3d.l2rel(ts), js.eval()[1]["u_val"]["L2Rel.u"], rtol=1e-4)


def _jax_stage_hooks(monkeypatch, n_nets):
    """Record the JAX example's initial weights and replace its solvers'
    ``train`` by three jitted steps and ``eval`` by one that records."""
    inits, j_losses, j_metrics = [], [], []
    mlp = psci.arch.MLP

    def record(i, o, n, w, **kw):
        m = mlp(i, o, LAYERS, WIDTH, **kw)
        inits.append(flatten_tree(jax.tree.map(np.asarray, m.param_tree())))
        return m

    def jax_train(self, num_fused_steps=None):
        j_losses.append(_jax_steps(self, STEPS, "jet")[1])
        self._sync_module()

    j_eval = psci.solver.Solver.eval

    def jax_eval(self, *args, **kw):
        out = j_eval(self, *args, **kw)
        j_metrics.append(out[0])
        return out

    monkeypatch.setattr(psci.arch, "MLP", record)
    monkeypatch.setattr(psci.solver.Solver, "train", jax_train)
    monkeypatch.setattr(psci.solver.Solver, "eval", jax_eval)
    return inits, j_losses, j_metrics


def _port_stages(gen, loads, inits):
    t_losses, t_metrics = [], []
    for i, ts in enumerate(gen):
        for model_idx, init_idx in loads.get(i, ()):
            load_jax_params(ts.models[model_idx], inits[init_idx])
        tpath.set_default(tpath.CANDIDATES["jet"])
        t_losses.append(_port_steps(ts, STEPS))
        t_metrics.append(ts.eval()[0])
    return t_losses, t_metrics


def test_deephpms_ns_stages_match_jax(tmp_path, monkeypatch):
    import deephpms_ns as jns

    for got, ref in zip(deephpms_ns.spectral_ns2d(nx=16, nt=3)[2][-1], jns.spectral_ns2d(nx=16, nt=3)[2][-1]):
        np.testing.assert_array_equal(got, ref)
    inits, j_losses, j_metrics = _jax_stage_hooks(monkeypatch, 2)
    jns.run(epochs=(1, 1), iters_per_epoch=1, output_dir=str(tmp_path), nx=16, nt=5, n_eval=400)
    gen = deephpms_ns.stages((1, 1), 1, output_dir=None, nx=16, nt=5, n_eval=400, width=WIDTH, num_layers=LAYERS,
                             pde_width=WIDTH, pde_layers=LAYERS, device="cpu")
    t_losses, t_metrics = _port_stages(gen, {0: [(0, 0)], 1: [(1, 1)]}, inits)
    for t, j in zip(t_losses, j_losses):
        np.testing.assert_allclose(t, j, rtol=1e-4)
    np.testing.assert_allclose(t_metrics, j_metrics, rtol=1e-4)


def test_deephpms_schrodinger_stages_match_jax(tmp_path, monkeypatch):
    import deephpms_schrodinger as jnls

    np.testing.assert_array_equal(deephpms_schrodinger.split_step_nls(nx=32, nt=3)[2],
                                  jnls.split_step_nls(nx=32, nt=3)[2])
    monkeypatch.setattr(jnls, "split_step_nls", functools.partial(jnls.split_step_nls, nx=32, nt=11))
    monkeypatch.setattr(jnls, "load_data", functools.partial(jnls.load_data, n_train=200))
    inits, j_losses, j_metrics = _jax_stage_hooks(monkeypatch, 4)
    jnls.run(epochs=(1, 1, 1), iters_per_epoch=1, output_dir=str(tmp_path))
    gen = deephpms_schrodinger.stages((1, 1, 1), 1, output_dir=None, n_train=200, nx=32, nt=11, width=WIDTH,
                                      num_layers=LAYERS, pde_width=WIDTH, pde_layers=LAYERS, device="cpu")
    t_losses, t_metrics = _port_stages(gen, {0: [(0, 0), (1, 1)], 1: [(2, 2), (3, 3)]}, inits)
    for t, j in zip(t_losses, j_losses):
        np.testing.assert_allclose(t, j, rtol=1e-4)
    np.testing.assert_allclose(t_metrics, j_metrics, rtol=1e-4)
