"""The port's L-BFGS (``optimizer/optimizer.py::LBFGS``, its zoom line
search ``optimizer/linesearch.py`` and the solver's L-BFGS step) against
optax and the JAX package on the CPU.

* Against ``optax.lbfgs(memory_size=100, linesearch=
  scale_by_zoom_linesearch(K))`` step by step (optax's
  ``value_and_grad_from_state`` pattern on both sides): the value each step
  starts from within 1e-5 relative, the accepted step size within 1e-4
  relative, the parameters within 1e-5 (relative to their largest
  magnitude) and the number of line-search trials equal, on a float32
  quadratic, Rosenbrock (in 8-D, where the zoom runs), a pseudo-Huber
  function whose minimum lies far away (the increase phase, then the
  zoom) and searches cut at ``max_linesearch_steps`` (a failed search: its
  safe step).
* ldc2d_steady with ``lbfgs=True`` (batches cut by ``iters_per_epoch=1``):
  three steps against the JAX solver's ``_build_lbfgs_step``, losses
  within 1e-4, trials equal, parameters within 1e-3 of their largest
  magnitude; a supervised constraint over an indexed data set (a new batch
  each step) shows the step starting from the value the last search
  stored on the previous batch, as in JAX.
* ``tests/test_solver.py::test_lbfgs_refinement``'s Adam then L-BFGS recipe
  in both packages: eval metrics within 1e-3 relative, and L-BFGS lowering
  it.
* A resumed L-BFGS run equals an unbroken one bitwise.
"""

import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import FAST, one_torch_thread  # noqa: F401
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import ldc2d_steady as tldc
from paddlescience_torch.optimizer.linesearch import cubicmin, quadmin
from paddlescience_torch.optimizer.optimizer import LBFGS, LBFGSOptimizer
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import ldc2d_steady as jldc  # noqa: E402  (the JAX example)


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


# ------------------------------------------------------- against optax --

def _rosen(lib):
    return lambda x: lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


_RNG = np.random.default_rng(0)
_Q = _RNG.standard_normal((6, 6)).astype(np.float32)
_A = (_Q @ _Q.T + 0.5 * np.eye(6)).astype(np.float32)
_B = _RNG.standard_normal(6).astype(np.float32)

# name: (optax objective, port objective, x0, max_linesearch_steps, steps, trial phases the port must show)
CASES = {
    "quadratic": (lambda x: 0.5 * x @ (jnp.asarray(_A) @ x) - jnp.asarray(_B) @ x,
                  lambda x: 0.5 * x @ (torch.from_numpy(_A) @ x) - torch.from_numpy(_B) @ x,
                  np.zeros(6, np.float32), 20, 8, {"interval"}),
    "rosenbrock_8d": (_rosen(jnp), _rosen(torch), np.random.default_rng(3).uniform(-2, 2, 8).astype(np.float32),
                      20, 12, {"interval", "zoom"}),
    "far_minimum": (lambda x: jnp.sum(jnp.sqrt(1.0 + (x - 100.0) ** 2)),
                    lambda x: torch.sum(torch.sqrt(1.0 + (x - 100.0) ** 2)),
                    np.zeros(3, np.float32), 20, 6, {"interval", "zoom"}),
    # cut at 3 trials: steps 0 and 2 fail in the increase phase, 1 and 3 in the zoom (safe steps returned)
    "failed_searches": (lambda x: jnp.sum(jnp.sqrt(1.0 + (x - 100.0) ** 2)),
                        lambda x: torch.sum(torch.sqrt(1.0 + (x - 100.0) ** 2)),
                        np.zeros(3, np.float32), 3, 4, {"interval", "zoom"}),
    # NaN beyond x0 = 0.5: the one trial is not finite, the safe step is 0, and 'keep' stays at 0
    "failed_at_nan": (lambda x: jnp.sum((x - 3.0) ** 2) + jnp.sqrt(0.5 - x[0]),
                      lambda x: torch.sum((x - 3.0) ** 2) + torch.sqrt(0.5 - x[0]),
                      np.zeros(2, np.float32), 1, 3, {"interval"}),
}


def _run_optax(f, x0, max_ls, steps):
    opt = optax.lbfgs(learning_rate=None, memory_size=100,
                      linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=max_ls))
    vag = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(x, state):
        v, g = vag(x, state=state)
        u, state = opt.update(g, state, x, value=v, grad=g, value_fn=f)
        return optax.apply_updates(x, u), state, v

    x, rows = jnp.asarray(x0), []
    state = opt.init(x)
    for _ in range(steps):
        x, state, v = step(x, state)
        info = state[-1].info
        # a search that ends without meeting both criteria keeps its last trial's errors
        failed = max(float(info.decrease_error), float(info.curvature_error)) > 0
        rows.append((float(v), float(state[-1].learning_rate), np.asarray(x), int(info.num_linesearch_steps),
                     failed))
    return rows


def _run_port(f, x0, max_ls, steps):
    p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    opt = LBFGSOptimizer([p], 100, max_ls)

    def vag(flat):
        opt.set_flat_params(flat)
        v = f(p)
        return v.detach(), torch.autograd.grad(v, [p])[0]

    rows, phases = [], set()
    for _ in range(steps):
        stored = opt.stored_value_and_grad()
        v, g = stored if stored is not None else vag(opt.flat_params())
        eta = opt.step(v, g, vag, evaluated=stored is None)
        phases |= set(opt.linesearch.trace)
        rows.append((float(v), float(eta), p.detach().numpy().copy(), len(opt.linesearch.trace),
                     opt.linesearch.failed))
    return rows, phases, opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_lbfgs_matches_optax_step_by_step(case):
    fj, ft, x0, max_ls, steps, want_phases = CASES[case]
    ref = _run_optax(fj, x0, max_ls, steps)
    got, phases, opt = _run_port(ft, x0, max_ls, steps)
    assert phases == want_phases
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g[3] == r[3], (i, g[3], r[3])  # line-search trials
        assert g[4] == r[4], (i, "failed", g[4], r[4])
        np.testing.assert_allclose(g[0], r[0], rtol=1e-5, err_msg=f"value, step {i}")
        np.testing.assert_allclose(g[1], r[1], rtol=1e-4, err_msg=f"step size, step {i}")
        np.testing.assert_allclose(g[2], r[2], rtol=1e-5, atol=1e-5 * np.abs(r[2]).max(), err_msg=f"x, step {i}")
    if case.startswith("failed"):
        assert any(r[4] for r in ref) and any(g[4] for g in got)
    assert opt.evaluations[0] == 1 + got[0][3] and opt.evaluations[1:] == [g[3] for g in got[1:]]


def test_interpolation_steps_match_optax():
    from optax._src.linesearch import _cubicmin, _quadmin

    rng = np.random.default_rng(7)
    for _ in range(50):
        a, b, c = np.sort(rng.uniform(0, 4, 3)).astype(np.float32)
        fa, fpa, fb, fc = rng.standard_normal(4).astype(np.float32)
        want_c = float(_cubicmin(jnp.float32(a), jnp.float32(fa), jnp.float32(fpa), jnp.float32(b),
                                 jnp.float32(fb), jnp.float32(c), jnp.float32(fc)))
        got_c = float(cubicmin(a, fa, fpa, b, fb, c, fc))
        assert (np.isnan(want_c) and np.isnan(got_c)) or np.isclose(got_c, want_c, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(quadmin(a, fa, fpa, b, fb)),
                                   float(_quadmin(jnp.float32(a), jnp.float32(fa), jnp.float32(fpa),
                                                  jnp.float32(b), jnp.float32(fb))), rtol=1e-5, atol=1e-6)


def test_lbfgs_refuses_other_line_searches_and_torch_lbfgs_is_not_used():
    with pytest.raises(ValueError, match="strong_wolfe"):
        LBFGS(line_search_fn=None)
    for name in ("optimizer/optimizer.py", "optimizer/linesearch.py", "solver/solver.py"):
        code = open(os.path.join(ROOT, "paddlescience_torch", name)).read()
        assert "optim.LBFGS(" not in code and "optim import LBFGS" not in code, name


# ------------------------------------------------ against the JAX solver --

def _jax_lbfgs_steps(js, steps):
    """``steps`` L-BFGS steps of the JAX solver's jitted step: (loss, trials) each."""
    step_fn, compiled = js._build_lbfgs_step(), None
    rows = []
    with jpath.override(jpath.CANDIDATES["jet"]):
        for _ in range(steps):
            host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
            if compiled is None:  # compiled once, at XLA's lowest optimisation level
                compiled = step_fn.lower(js.state, host).compile(compiler_options=FAST)
            js.state, logs = compiled(js.state, host)
            info = optax.tree_utils.tree_get(js.state["opt_state"], "info")
            rows.append((float(logs["loss"]), int(info.num_linesearch_steps)))
    return rows


def _port_lbfgs_steps(ts, steps):
    rows = []
    for _ in range(steps):
        logs = ts.train_step()
        rows.append((float(logs["loss"]), len(ts.optimizer.linesearch.trace)))
    return rows


def _assert_params_close(ts, js, atol_rel):
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    scale = max(np.abs(v).max() for v in j_params.values())
    for n, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=0, atol=atol_rel * scale, err_msg=n)


def test_ldc2d_lbfgs_three_steps_match_jax_solver(tmp_path):
    js = jldc.build_solver(iters_per_epoch=1, output_dir=str(tmp_path / "jax"), lbfgs=True)
    ts = tldc.build_solver(iters_per_epoch=1, output_dir=str(tmp_path / "port"), lbfgs=True, device="cpu")
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    assert ts.constraint["EQ"].dataset.input["x"].shape == (2048, 1)
    ref, got = _jax_lbfgs_steps(js, 3), _port_lbfgs_steps(ts, 3)
    assert [g[1] for g in got] == [r[1] for r in ref]
    np.testing.assert_allclose([g[0] for g in got], [r[0] for r in ref], rtol=1e-4)
    _assert_params_close(ts, js, 1e-3)
    assert ts.optimizer.evaluations == [1 + got[0][1]] + [g[1] for g in got[1:]]


def _supervised_pair(tmp_path):
    """A 2 -> 1 MLP fit to a smooth target over 48 rows in batches of 16
    (shuffle off), L-BFGS(max_iter=6), in both packages."""
    from paddlescience_torch.arch.mlp import MLP as TMLP
    from paddlescience_torch.constraint.constraints import SupervisedConstraint as TSup
    from paddlescience_torch.loss.losses import MSELoss as TMSE
    from paddlescience_torch.solver.solver import Solver as TSolver
    from paddlescience_tpu.nn.core import Rngs

    rng = np.random.default_rng(4)
    xy = rng.uniform(-1, 1, (48, 2)).astype(np.float32)
    inp = {"x": xy[:, :1], "y": xy[:, 1:]}
    lab = {"u": (np.sin(2 * xy[:, :1]) * xy[:, 1:]).astype(np.float32)}
    cfg = {"dataset": {"name": "NamedArrayDataset", "input": inp, "label": lab}, "batch_size": 16,
           "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": True}}
    jm = psci.arch.MLP(("x", "y"), ("u",), 2, 16, rngs=Rngs(5))
    js = psci.solver.Solver(jm, {"Sup": psci.constraint.SupervisedConstraint(cfg, psci.loss.MSELoss(), name="Sup")},
                            str(tmp_path / "jax"), psci.optimizer.LBFGS(max_iter=6)(jm), epochs=1, iters_per_epoch=3)
    tm = TMLP(("x", "y"), ("u",), 2, 16, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    ts = TSolver(tm, {"Sup": TSup(cfg, TMSE(), name="Sup")}, str(tmp_path / "port"), LBFGS(max_iter=6)(tm),
                 epochs=1, iters_per_epoch=3, device="cpu")
    return js, ts


def test_lbfgs_starts_each_step_from_the_value_stored_on_the_previous_batch(tmp_path):
    """optax's ``value_and_grad_from_state``: step k > 1 logs (and starts
    from) the value the last search accepted on batch k - 1, not the loss
    of the same parameters on batch k; both packages agree step by step."""
    js, ts = _supervised_pair(tmp_path)
    ref = _jax_lbfgs_steps(js, 3)
    got, fresh = [], []
    for _ in range(3):
        before = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
        got.append(_port_lbfgs_steps(ts, 1)[0])
        batch = {k: v[ts._chunk_pos] for k, v in ts._chunk["Sup"][0].items()}
        label = {k: v[ts._chunk_pos] for k, v in ts._chunk["Sup"][1].items()}
        with torch.no_grad():
            params = dict(ts.model.named_parameters())
            saved = {n: p.clone() for n, p in params.items()}
            for n, p in params.items():
                p.copy_(before[n])
            fresh.append(float(((ts.model(batch)["u"] - label["u"]) ** 2).mean()))
            for n, p in params.items():
                p.copy_(saved[n])
    assert [g[1] for g in got] == [r[1] for r in ref]
    np.testing.assert_allclose([g[0] for g in got], [r[0] for r in ref], rtol=1e-4)
    _assert_params_close(ts, js, 1e-4)
    assert np.isclose(got[0][0], fresh[0], rtol=1e-6)  # the first step evaluates on its own batch
    for k in (1, 2):  # later steps start from the previous batch's stored value
        assert not np.isclose(got[k][0], fresh[k], rtol=1e-3), (k, got[k][0], fresh[k])


def _tiny_laplace(tmp_path, tag, epochs, iters, lbfgs, port):
    """``tests/test_solver.py::_tiny_laplace_solver`` in either package."""
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters}
    if port:
        from paddlescience_torch import geometry as geo
        from paddlescience_torch import metric as met
        from paddlescience_torch import validate as val
        from paddlescience_torch.arch.mlp import MLP
        from paddlescience_torch.constraint import constraints as cst
        from paddlescience_torch.equation.pde.basic import Laplace
        from paddlescience_torch.loss import losses as los
        from paddlescience_torch.optimizer import optimizer as opt_cls
        from paddlescience_torch.solver import solver as sol

        np.random.seed(0)
        random.seed(0)
        model = MLP(("x", "y"), ("u",), 3, 16, generator=torch.Generator().manual_seed(0), device="cpu")
        eq = Laplace(dim=2)
    else:
        psci.utils.set_random_seed(0)
        model = psci.arch.MLP(("x", "y"), ("u",), 3, 16)
        eq = psci.equation.Laplace(dim=2)
        opt_cls, geo, cst, los, met, val, sol = (psci.optimizer, psci.geometry, psci.constraint, psci.loss,
                                                 psci.metric, psci.validate, psci.solver)
    rect = geo.Rectangle((0.0, 0.0), (1.0, 1.0))
    u_np = lambda out: np.cos(out["x"]) * np.cosh(out["y"])
    pde = cst.InteriorConstraint(eq.equations, {"laplace": 0}, rect, {**cfg, "batch_size": 256},
                                 los.MSELoss("sum"), name="EQ")
    bc = cst.BoundaryConstraint({"u": lambda out: out["u"]}, {"u": u_np}, rect, {**cfg, "batch_size": 64},
                                los.MSELoss("sum"), name="BC")
    validator = {"mse": val.GeometryValidator({"u": lambda out: out["u"]}, {"u": u_np}, rect,
                                              {"dataset": "IterableNamedArrayDataset", "total_size": 128},
                                              los.MSELoss(), metric={"MSE": met.MSE()}, name="mse")}
    opt = opt_cls.LBFGS(max_iter=15)(model) if lbfgs else opt_cls.Adam(1e-3)(model)
    kw = {"device": "cpu"} if port else {}
    return sol.Solver(model, {"EQ": pde, "BC": bc}, str(tmp_path / tag), opt, epochs=epochs, iters_per_epoch=iters,
                      validator=validator, equation={"laplace": eq}, log_freq=100, **kw)


def test_adam_then_lbfgs_recipe_matches_jax(tmp_path):
    """``tests/test_solver.py::test_lbfgs_refinement`` in both packages,
    cut to 1 x 3 Adam steps, then a second solver with ``LBFGS(max_iter=15)``
    starting from the Adam solver's parameters for 6 steps (6 x 256
    interior and 6 x 64 boundary points, where the JAX test has 15 x)."""
    js = _tiny_laplace(tmp_path, "jax_adam", 1, 3, False, port=False)
    ts = _tiny_laplace(tmp_path, "port_adam", 1, 3, False, port=True)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    with jpath.override(jpath.CANDIDATES["jet"]):
        js.train()
        jm0 = float(js.eval()[0])
    ts.train()
    tm0 = ts.eval()[0]
    np.testing.assert_allclose(tm0, jm0, rtol=1e-4)
    js2 = _tiny_laplace(tmp_path, "jax_lbfgs", 1, 6, True, port=False)
    js2.state["params"] = js.state["params"]
    js2.state["opt_state"] = js2._tx().init(js2._opt_target(js2.state))
    ts2 = _tiny_laplace(tmp_path, "port_lbfgs", 1, 6, True, port=True)
    ts2._load_state({"params": dict(ts.model.named_parameters())}, params_only=True)
    with jpath.override(jpath.CANDIDATES["jet"]):
        js2.train()
        jm1 = float(js2.eval()[0])
    ts2.train()
    tm1 = ts2.eval()[0]
    assert tm1 < tm0 and jm1 < jm0
    np.testing.assert_allclose(tm1, jm1, rtol=1e-3)


def test_lbfgs_resume_is_bitwise(tmp_path):
    """Two epochs of L-BFGS, against one epoch, a resume from ``latest``
    (memory, line-search state, step) and the second epoch."""
    from paddlescience_torch.solver.solver import Solver

    def build(tag, **kw):
        return tldc.build_solver(epochs=2, iters_per_epoch=1, output_dir=str(tmp_path / tag), lbfgs=True,
                                 device="cpu", **kw)

    full = build("full")
    full.train()
    half = tldc.build_solver(epochs=1, iters_per_epoch=1, output_dir=str(tmp_path / "half"), lbfgs=True, device="cpu")
    half.train()
    resumed = build("resumed")
    resumed.__init__(resumed.model, resumed.constraint, str(tmp_path / "resumed"), resumed.optimizer, epochs=2,
                     iters_per_epoch=1, validator=resumed.validator, equation=resumed.equation, device="cpu",
                     checkpoint_path=str(tmp_path / "half" / "checkpoints" / "latest"))
    assert isinstance(resumed, Solver) and resumed.last_epoch == 1 and resumed.optimizer.count == 1
    resumed.train()
    a, b = full.state_dict(), resumed.state_dict()
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for part in a["opt_state"]:
        for k, v in a["opt_state"][part].items():
            assert torch.equal(v, b["opt_state"][part][k]), (part, k)
    assert a["step"] == b["step"] == 2 and full.optimizer.evaluations[1:] == resumed.optimizer.evaluations
