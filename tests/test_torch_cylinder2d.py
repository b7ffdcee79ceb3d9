"""The port's cylinder2d example and TIPC workload against the JAX package
on the CPU.

The JAX example (``examples/cylinder2d_unsteady.py::build_solver``) hard-
codes its batch sizes; here its constraint and validator classes are
wrapped so that each size shrinks (4096 -> 64 interior points, 512 -> 16
boundary, 1024 -> 16 initial, at two iterations per epoch), and the
port's ``build_solver`` takes the same sizes as arguments. Checked: every
constraint batch bitwise (and the TIPC workload's full 299,280-point
batches against ``bench.py::build_matched_cylinder``); three train steps
against the JAX solver's jitted step (losses 1e-4 relative, the learning
rates through the cosine warmup, parameters within 1e-2 lr) on the jet
path, the MLP kernels' path (plain versions here) and under ``jvp``; the
Cosine schedule with warmup in float32 against the JAX schedule to 1e-6
(relative to the schedule's peak) at every step; the residual validator
within 1e-5.
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
from paddlescience_tpu.optimizer import lr_scheduler as jlr
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import cylinder2d_unsteady as tcyl
from paddlescience_torch.optimizer import lr_scheduler as tlr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import cylinder2d_unsteady as jcyl  # noqa: E402  (the JAX example)

EPOCHS, IPE, LR, STEPS = 4, 2, 1e-3, 3
CUT = {4096: 64, 512: 16, 1024: 16}  # the JAX example's batch sizes -> the cut ones
VALIDATOR_POINTS = 64
LOSS_KEYS = ("loss", "loss/EQ", "loss/BC_inlet", "loss/BC_cylinder", "loss/IC", "lr")


@pytest.fixture(autouse=True)
def _float32_and_paths(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _cut_cls(cls, key):
    def build(*args, **kw):
        args = list(args)
        cfg = dict(args[3])
        cfg[key] = CUT[cfg[key]] if key == "batch_size" else VALIDATOR_POINTS
        args[3] = cfg
        return cls(*args, **kw)

    return build


def _jax_solver(monkeypatch, tmp_path):
    for name in ("InteriorConstraint", "BoundaryConstraint", "InitialConstraint"):
        monkeypatch.setattr(psci.constraint, name, _cut_cls(getattr(psci.constraint, name), "batch_size"))
    monkeypatch.setattr(psci.validate, "GeometryValidator", _cut_cls(psci.validate.GeometryValidator, "total_size"))
    return jcyl.build_solver(epochs=EPOCHS, iters_per_epoch=IPE, output_dir=str(tmp_path / "jax"))


def _port_solver(tmp_path, deriv="jet_pallas_full"):
    return tcyl.build_solver(epochs=EPOCHS, iters_per_epoch=IPE, output_dir=str(tmp_path / "port"),
                             pde_points=CUT[4096], bc_points=CUT[512], ic_points=CUT[1024],
                             validator_points=VALIDATOR_POINTS, deriv=deriv, device="cpu")


def _solvers(monkeypatch, tmp_path, deriv="jet_pallas_full"):
    js = _jax_solver(monkeypatch, tmp_path)
    ts = _port_solver(tmp_path, deriv)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    return js, ts


def _assert_same_datasets(jcsts, tcsts):
    assert list(tcsts) == list(jcsts)
    for name in jcsts:
        jd, td = jcsts[name].dataset, tcsts[name].dataset
        for part in ("input", "label"):
            a, b = getattr(jd, part), getattr(td, part)
            assert list(a) == list(b), (name, part)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, part, k)


def test_constraint_batches_bitwise(monkeypatch, tmp_path):
    js, ts = _solvers(monkeypatch, tmp_path)
    _assert_same_datasets(js.constraint, ts.constraint)
    assert {n: len(c.dataset.input["t"]) for n, c in ts.constraint.items()} == {
        "EQ": 64 * IPE, "BC_inlet": 16 * IPE, "BC_cylinder": 16 * IPE, "IC": 16 * IPE}
    inlet, ic = ts.constraint["BC_inlet"].dataset.input, ts.constraint["IC"].dataset.input
    assert np.allclose(inlet["x"], -4.0) and np.all(ic["t"] == 0.0)
    jv, tv = js.validator["residual"].dataset, ts.validator["residual"].dataset
    for k in jv.input:
        assert np.array_equal(jv.input[k], tv.input[k]), k


def test_matched_workload_batches_bitwise(monkeypatch):
    """The TIPC workload at its full size: the same 299,280 points a step as
    ``bench.py``'s JAX function, bitwise, and the count from the shapes."""
    monkeypatch.setenv("PSCI_MATMUL_PRECISION", os.environ.get("PSCI_MATMUL_PRECISION", "high"))
    sys.path.insert(0, ROOT)
    import bench  # noqa: E402  (its import sets PSCI_MATMUL_PRECISION only where unset)

    js, j_points = bench.build_matched_cylinder(1)
    ts, t_points = tcyl.build_matched_solver(1, deriv="jet_pallas_full", device="cpu")
    assert t_points == j_points == 282600 + 4830 + 2430 + 9420
    _assert_same_datasets(js.constraint, ts.constraint)
    assert ts.iters_per_epoch == 1 and ts.epochs == 1


@pytest.mark.parametrize("deriv", ["jet", "jet_pallas_full", "jvp"])
def test_three_train_steps_match_jax_solver(monkeypatch, tmp_path, deriv):
    js, ts = _solvers(monkeypatch, tmp_path, deriv)
    j_logs = []
    with jpath.override(jpath.CANDIDATES["jet"]):
        step_fn = js._build_train_step()
        for _ in range(STEPS):
            host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
            js.state, logs = step_fn(js.state, host)
            j_logs.append([float(logs[k]) for k in LOSS_KEYS])
    t_logs = [[float(v) for v in map(ts.train_step().__getitem__, LOSS_KEYS)] for _ in range(STEPS)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4, atol=1e-12)
    assert [row[-1] for row in t_logs] == pytest.approx([0.0, LR / 2, LR], rel=1e-6)  # warmup of 2 steps
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    diffs = np.concatenate([np.abs(p.detach().numpy() - j_params[n]).ravel() for n, p in ts.model.named_parameters()])
    assert diffs.max() <= 1e-2 * LR


SCHEDULES = {
    "example": dict(epochs=40, iters_per_epoch=50, learning_rate=1e-3, warmup_epoch=2),
    "eta_min_start_lr": dict(epochs=12, iters_per_epoch=7, learning_rate=3e-3, eta_min=1e-4, warmup_epoch=3,
                             warmup_start_lr=5e-4),
    "by_epoch": dict(epochs=10, iters_per_epoch=13, learning_rate=1e-2, warmup_epoch=2, by_epoch=True),
    "no_warmup": dict(epochs=5, iters_per_epoch=9, learning_rate=2e-3),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_cosine_schedule_matches_jax(name):
    """Every step of the schedule, through warmup and decay and one step
    past the end: the float form and the float32 tensor form (what a
    captured step reads) against the JAX schedule in float32."""
    kw = SCHEDULES[name]
    n = kw["epochs"] * kw["iters_per_epoch"] + 1
    ref = np.asarray(jlr.Cosine(**kw)()(jnp.arange(n)), np.float32)
    sched = tlr.Cosine(**kw)()
    got_t = sched(torch.arange(n, dtype=torch.float32))
    assert got_t.dtype == torch.float32
    atol = 1e-6 * float(np.abs(ref).max())  # near the end of the decay 1 + cos cancels
    np.testing.assert_allclose(got_t.numpy(), ref, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(np.array([sched(i) for i in range(n)], np.float32), ref, rtol=1e-6, atol=atol)
    assert sched.by_epoch == kw.get("by_epoch", False)


def test_constant_schedule_matches_jax():
    ref = float(jlr.Constant(2.5e-4)()(jnp.asarray(7)))
    sched = tlr.Constant(2.5e-4)()
    assert sched(7) == pytest.approx(ref, rel=1e-7)
    got = sched(torch.tensor(7.0))
    assert got.dtype == torch.float32 and float(got) == ref


def test_residual_validator_matches_jax(monkeypatch, tmp_path):
    js, ts = _solvers(monkeypatch, tmp_path)
    with jpath.override(jpath.CANDIDATES["jet"]):
        j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert list(t_group) == list(j_group) == ["residual"]
    assert list(t_group["residual"]) == list(j_group["residual"])
    for k, v in j_group["residual"].items():
        np.testing.assert_allclose(t_group["residual"][k], float(v), rtol=1e-5)
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-5)
