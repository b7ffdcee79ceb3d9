"""The port's losses, aggregators, weight averages, L-BFGS over learnable
equation parameters, constraint and equation builders and the sympy-free
expression reader against paddlescience_tpu on the CPU.

Each loss on numpy-seeded outputs and labels: values and their gradients
within 1e-5. Each aggregator (Relobralo with the same rho sequence
injected on both sides; PCGrad; AGDA) and each weight average (EMA, SWA)
on a small two-constraint problem: the JAX solver's jitted steps (5) against
the port's from the same weights, losses and parameters within 1e-5.
L-BFGS over a small network and Vibration's k1, k2 (viv's data) for 3 steps against the JAX
solver's L-BFGS step. ``PeriodicConstraint``, ``build_constraint`` and
``build_equation`` against the JAX builders on one config (the sampled
points bitwise, one step's losses within 1e-5). The expression reader
against sympy on 20 expressions.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import jacobian as jjacobian
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_torch import constraint as tconstraint
from paddlescience_torch import equation as tequation
from paddlescience_torch import loss as tloss
from paddlescience_torch.arch import MLP as TMLP
from paddlescience_torch.autodiff import jacobian as tjacobian
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.geometry import Rectangle as TRectangle
from paddlescience_torch.optimizer import LBFGS as TLBFGS
from paddlescience_torch.optimizer import Adam as TAdam
from paddlescience_torch.solver import Solver as TSolver
from paddlescience_torch.utils import ema as tema
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_eq_params, load_jax_params
from paddlescience_torch.utils.symbolic import read_expression

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))


@pytest.fixture(autouse=True)
def _highest_precision():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


# -------------------------------------------------------------- losses --

def _arrays(shape, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


LOSSES = {
    "L1Loss": (dict(reduction="sum", weight=0.5), (8, 2)),
    "MAELoss": (dict(weight={"u": 2.0}), (8, 2)),
    "L2Loss": (dict(), (8, 3)),
    "PeriodicL1Loss": (dict(weight=3.0), (8, 1)),
    "PeriodicL2Loss": (dict(reduction="sum"), (8, 2)),
    "KLLoss": (dict(), (6, 4)),
    "ChamferLoss": (dict(), (2, 5, 3)),
    "MSELossWithL2Decay": (dict(regularization_dict={"u": 0.1}), (8, 1)),
    "CausalMSELoss": (dict(n_chunks=4, weight=2.0, tol=0.5), (8, 1)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_values_and_gradients_match_jax(name):
    kw, shape = LOSSES[name]
    out, lab = _arrays(shape)
    w = np.abs(_arrays(shape, 1, seed=3)[0]) if name in ("L1Loss", "L2Loss") else None
    area = np.full(shape[:1] + (1,), 0.25, np.float32) if name in ("L1Loss", "L2Loss") else None

    def jfn(o):
        od = {"u": o, **({"area": jnp.asarray(area)} if area is not None else {})}
        res = getattr(psci.loss, name)(**kw)(od, {"u": jnp.asarray(lab)}, {"u": jnp.asarray(w)} if w is not None else None)
        return sum(res.values()), res

    (jtot, jres), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(out))
    o = torch.from_numpy(out.copy()).requires_grad_(True)
    od = {"u": o, **({"area": torch.from_numpy(area)} if area is not None else {})}
    tres = tloss.build_loss({"name": name, **kw})(od, {"u": torch.from_numpy(lab)},
                                                  {"u": torch.from_numpy(w)} if w is not None else None)
    assert set(tres) == set(jres)
    for k in jres:
        np.testing.assert_allclose(float(tres[k].detach()), float(jres[k]), rtol=1e-5)
    sum(tres.values()).backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)


def test_functional_loss_keeps_its_weight_as_jax():
    f = lambda out, lab, w: {"x": (out["u"] ** 2).sum()}
    j = psci.loss.FunctionalLoss(f, weight=3.0)({"u": jnp.ones((2, 1))})
    t = tloss.FunctionalLoss(f, weight=3.0)({"u": torch.ones(2, 1)})
    assert t["x"].item() == float(j["x"]) == 2.0


# -------------------------------------------- a two-constraint problem --

N = 64
RHOS = [1.0, 0.0, 1.0, 0.0, 1.0]


def _data():
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(-1, 1, (N, 1)).astype(np.float32) for _ in range(2))
    return {"x": x, "y": y}, {"u": (np.sin(3 * x) + y).astype(np.float32)}, {"du": np.cos(3 * x).astype(np.float32)}


def _cfg(inp, lab):
    return {"dataset": {"name": "IterableNamedArrayDataset", "input": inp, "label": lab}}


def _jax_solver(aggregator=None, ema=None):
    inp, lab_a, lab_b = _data()
    model = psci.arch.MLP(("x", "y"), ("u",), 2, 16)
    cst = {"A": psci.constraint.SupervisedConstraint(_cfg(inp, lab_a), psci.loss.MSELoss(), {"u": lambda o: o["u"]},
                                                     name="A"),
           "B": psci.constraint.SupervisedConstraint(_cfg(inp, lab_b), psci.loss.MSELoss(),
                                                     {"du": lambda o: jjacobian(o["u"], o["x"])}, name="B")}
    return psci.solver.Solver(model, cst, None, psci.optimizer.Adam(1e-3)(model), epochs=1, iters_per_epoch=5,
                              loss_aggregator=aggregator, ema_avg=ema)


def _port_solver(js, aggregator=None, ema=None):
    inp, lab_a, lab_b = _data()
    model = TMLP(("x", "y"), ("u",), 2, 16, device="cpu")
    load_jax_params(model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    cst = {"A": tconstraint.SupervisedConstraint(_cfg(inp, lab_a), tloss.MSELoss(), {"u": lambda o: o["u"]}, name="A"),
           "B": tconstraint.SupervisedConstraint(_cfg(inp, lab_b), tloss.MSELoss(),
                                                 {"du": lambda o: tjacobian(o["u"], o["x"])}, name="B")}
    return TSolver(model, cst, None, TAdam(1e-3)(model), epochs=1, iters_per_epoch=5, loss_aggregator=aggregator,
                   ema_avg=ema, device="cpu")


def _jax_run(js, steps):
    out = []
    with jpath.override(jpath.CANDIDATES["jet"]):
        step_fn = js._build_train_step()
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        for _ in range(steps):
            js.state, logs = step_fn(js.state, host)
            out.append([float(logs["loss"]), float(logs["loss/A"]), float(logs["loss/B"])])
    return out


def _port_run(ts, steps):
    tpath.set_default(tpath.CANDIDATES["jet"])
    out = []
    for _ in range(steps):
        logs = ts.train_step()
        out.append([float(logs["loss"]), float(logs["loss/A"]), float(logs["loss/B"])])
    return out


def _params_close(ts_params, jtree, rtol=1e-5):
    ref = flatten_tree(jax.tree.map(np.asarray, jtree))
    assert set(ref) == set(ts_params)
    for k, v in ref.items():
        np.testing.assert_allclose(ts_params[k].detach().numpy(), v, rtol=rtol, atol=rtol * np.abs(v).max(), err_msg=k)


class _JaxRelobralo(psci.loss.mtl.Relobralo):
    """The JAX class with rho = RHOS[step] (its key argument carries it
    into the patched ``jax.random.bernoulli``)."""

    def aggregate(self, losses, state, step, grad_norms=None, key=None):
        return super().aggregate(losses, state, step, grad_norms, key=jnp.asarray(RHOS)[step])


class _PortRelobralo(tloss.mtl.Relobralo):
    def rho(self, step, generator):
        return torch.tensor(RHOS)[step.long()]


AGGREGATORS = {
    "relobralo": (lambda: _JaxRelobralo(None, 2, alpha=0.9, tau=0.5), lambda: _PortRelobralo(None, 2, alpha=0.9, tau=0.5)),
    "pcgrad": (lambda: psci.loss.mtl.PCGrad(None, 2), lambda: tloss.mtl.build_mtl_aggregator({"name": "PCGrad"})),
    "agda": (lambda: psci.loss.mtl.AGDA(None, 2), lambda: tloss.mtl.AGDA(None, 2)),
    "ema": (lambda: psci.utils.ema.ExponentialMovingAverage(decay=0.8, avg_freq=2),
            lambda: tema.ExponentialMovingAverage(decay=0.8, avg_freq=2)),
    "swa": (lambda: psci.utils.ema.StochasticWeightAverage(avg_range=(2, 4)),
            lambda: tema.StochasticWeightAverage(avg_range=(2, 4))),
}


@pytest.mark.parametrize("name", list(AGGREGATORS))
def test_aggregator_or_average_steps_match_jax(name, monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p: key > 0.5)
    jmake, tmake = AGGREGATORS[name]
    averaging = name in ("ema", "swa")
    js = _jax_solver(**({"ema": jmake()} if averaging else {"aggregator": jmake()}))
    ts = _port_solver(js, **({"ema": tmake()} if averaging else {"aggregator": tmake()}))
    steps = 5
    np.testing.assert_allclose(_port_run(ts, steps), _jax_run(js, steps), rtol=1e-5)
    _params_close(dict(ts.model.named_parameters()), js.state["params"])
    if averaging:
        _params_close(ts.avg_params, js.state["avg_params"])
    if name == "relobralo":
        for k in ("losses_init", "losses_prev", "lmbda"):
            np.testing.assert_allclose(ts.agg_state[k].numpy(), np.asarray(js.state["agg_state"][k]), rtol=1e-5)


def test_relobralo_draws_rho_at_rate_beta():
    agg = tloss.mtl.Relobralo(None, 2, beta=0.9)
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([agg.rho(torch.tensor(1.0), g) for _ in range(4000)])
    assert set(draws.unique().tolist()) == {0.0, 1.0} and abs(float(draws.mean()) - 0.9) < 0.02
    assert float(agg.rho(torch.tensor(1.0), None)) == 1.0


def test_ema_average_rides_in_the_checkpoint_and_eval_uses_it(tmp_path):
    js = _jax_solver()
    ts = _port_solver(js, ema=tema.ExponentialMovingAverage(decay=0.5))
    ts.output_dir = str(tmp_path)
    ts.train_steps(3)
    ts._save("latest")
    again = _port_solver(js, ema=tema.ExponentialMovingAverage(decay=0.5))
    from paddlescience_torch.utils import save_load

    state = save_load.load_checkpoint(os.path.join(str(tmp_path), "checkpoints", "latest"))
    state.pop("_metric")
    again._load_state(state)
    for n, v in ts.avg_params.items():
        assert torch.equal(again.avg_params[n], v)
    assert not all(torch.equal(ts.avg_params[n], p) for n, p in ts.model.named_parameters())


# ---------------------------------------------------- L-BFGS, equations --

def test_lbfgs_with_learnable_equation_parameters_matches_jax(tmp_path):
    import viv as jviv

    from paddlescience_torch.examples import viv as tviv

    js0 = jviv.build_solver(epochs=1, iters_per_epoch=3, output_dir=str(tmp_path))
    jm = psci.arch.MLP(("t_f",), ("eta",), 2, 8, activation="tanh")
    js = psci.solver.Solver(jm, js0.constraint, None, psci.optimizer.LBFGS(max_iter=5)(jm), epochs=1,
                            iters_per_epoch=3, equation=js0.equation)
    ts0 = tviv.build_solver(epochs=1, iters_per_epoch=3, output_dir=None, device="cpu", deriv="jet")
    tm = TMLP(("t_f",), ("eta",), 2, 8, activation="tanh", device="cpu")
    ts = TSolver(tm, ts0.constraint, None, TLBFGS(max_iter=5)(tm), epochs=1, iters_per_epoch=3,
                 equation=ts0.equation, device="cpu")
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    load_jax_eq_params(ts.eq_params, {k: np.asarray(v) for k, v in js.state["eq_params"].items()})
    assert ts.optimizer.params()[-2:] == [ts.eq_params["k1"], ts.eq_params["k2"]]
    j_out, t_out = [], []
    with jpath.override(jpath.CANDIDATES["jet"]):
        step_fn = js._build_lbfgs_step()
        host = {"Sup": jax.tree.map(jnp.asarray, next(js.constraint["Sup"].data_iter))}
        for _ in range(3):
            js.state, logs = step_fn(js.state, host)
            j_out.append([float(logs["loss"]), float(js.state["eq_params"]["k1"]), float(js.state["eq_params"]["k2"])])
    for _ in range(3):
        logs = ts.train_step()
        t_out.append([float(logs["loss"]), float(ts.eq_params["k1"]), float(ts.eq_params["k2"])])
    np.testing.assert_allclose(t_out, j_out, rtol=1e-4)
    assert t_out[-1][1:] != t_out[0][1:]


def test_periodic_constraint_and_builders_match_jax():
    eq_cfg = [{"name": "Poisson", "dim": 2}, {"name": "NavierStokes", "nu": "nu * 2", "rho": 1.0, "dim": 2,
                                              "time": False}]
    jeq, teq = psci.equation.build_equation(eq_cfg), tequation.build_equation(eq_cfg)
    assert list(teq) == list(jeq) and type(teq["Poisson"]).__name__ == "Poisson"
    assert list(tequation.build_equation({"Laplace": {"dim": 2}})) == ["Laplace"]
    with pytest.raises(ValueError, match="unknown equation"):
        tequation.build_equation([{"name": "Nope"}])
    x, y = sympy.symbols("x y")

    def cfg():
        return {"dataloader": {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": 1},
                "content": [
                    {"InteriorConstraint": {"output_expr": "Poisson", "label_dict": {"poisson": x * y},
                                            "geom": "rect", "dataloader": {"batch_size": 64},
                                            "loss": {"name": "MSELoss"}, "weight_dict": {"poisson": 1 + x**2},
                                            "name": "EQ"}},
                    {"PeriodicConstraint": {"output_expr": {"p": lambda out: out["p"]}, "label_dict": {"p": 0},
                                            "geom": "rect", "periodic_key": "x", "dataloader": {"batch_size": 32},
                                            "loss": {"name": "PeriodicL2Loss"},
                                            "criteria": "lambda x, y: np.isclose(x, 0.0)", "name": "PBC"}}]}

    np.random.seed(11)
    jc = psci.constraint.build_constraint(cfg(), jeq, {"rect": psci.geometry.Rectangle((0.0, 0.0), (1.0, 2.0))})
    np.random.seed(11)
    tc = tconstraint.build_constraint(cfg(), teq, {"rect": TRectangle((0.0, 0.0), (1.0, 2.0))})
    assert list(tc) == list(jc) == ["EQ", "PBC"]
    for n in jc:
        for jp, tp in zip(next(jc[n].data_iter), next(tc[n].data_iter)):
            assert set(jp or {}) == set(tp or {})
            for k in jp or {}:
                np.testing.assert_allclose(np.asarray(tp[k]), np.asarray(jp[k]), rtol=1e-6, err_msg=f"{n} {k}")
    pin = next(tc["PBC"].data_iter)[0]
    assert (pin["x"][:16] == 0.0).all() and (pin["x"][16:] == 1.0).all()  # points at x = 0, their images at x = 1
    model = psci.arch.MLP(("x", "y"), ("p",), 2, 8)
    js = psci.solver.Solver(model, jc, None, psci.optimizer.Adam(1e-3)(model), epochs=1, iters_per_epoch=1,
                            equation=jeq)
    tm = TMLP(("x", "y"), ("p",), 2, 8, device="cpu")
    load_jax_params(tm, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    ts = TSolver(tm, tc, None, TAdam(1e-3)(tm), epochs=1, iters_per_epoch=1, equation=teq, device="cpu")
    js_logs = _jax_logs(js)
    tpath.set_default(tpath.CANDIDATES["jet"])
    t_logs = ts.train_step()
    for k in ("loss", "loss/EQ", "loss/PBC"):
        np.testing.assert_allclose(float(t_logs[k]), js_logs[k], rtol=1e-5)


def _jax_logs(js):
    with jpath.override(jpath.CANDIDATES["jet"]):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        js.state, logs = js._build_train_step()(js.state, host)
    return {k: float(v) for k, v in logs.items()}


# ------------------------------------------------------ the reader --

EXPRESSIONS = ["x + y", "x*y - 3", "x**2 + 2*x*y", "-x/3 + y", "sin(x)*cos(y)", "exp(-x**2)", "log(1 + x**2)",
               "sqrt(1 + y**2)", "tanh(2*x) - tan(y/4)", "Abs(x - y)", "pi*x", "E**x", "2*pi*sin(pi*x)*sin(pi*y)",
               "x**3/6 - y**(1/2)", "1/(1 + exp(-x))", "(x + 1)*(y - 2)/(x**2 + 1)", "3.5e-2*x", "-(x + y)**2",
               "exp(sin(x))*log(2 + cos(y))", "Abs(sin(x))**1.5"]


@pytest.mark.parametrize("text", EXPRESSIONS)
def test_reader_matches_sympy(text):
    x, y = sympy.symbols("x y")
    expr = sympy.sympify(text)
    rng = np.random.default_rng(0)
    vals = {"x": rng.uniform(0.1, 1.5, (16, 1)).astype(np.float32), "y": rng.uniform(0.1, 1.5, (16, 1)).astype(np.float32)}
    ref = np.broadcast_to(sympy.lambdify((x, y), expr, "numpy")(vals["x"], vals["y"]), (16, 1))
    got_np = read_expression(str(expr))({k: vals[k] for k in read_expression(str(expr)).names}, "numpy")
    got_t = read_expression(text)({k: torch.from_numpy(v) for k, v in vals.items()})
    np.testing.assert_allclose(np.broadcast_to(got_np, (16, 1)), ref, rtol=1e-5)
    np.testing.assert_allclose(np.broadcast_to(np.asarray(got_t), (16, 1)), ref, rtol=1e-5)


def test_reader_raises_on_forms_outside_its_grammar():
    x = sympy.Symbol("x")
    u = sympy.Function("u")(x)
    for text in (str(u.diff(x)), "Max(x, 1)", "x > 1", "u(x)"):
        with pytest.raises(NotImplementedError, match="form"):
            read_expression(text)
    with pytest.raises(NotImplementedError, match="not coordinates"):
        tconstraint.constraints.prepare_label({"u": x * sympy.Symbol("k")}, {"x": np.ones((2, 1), np.float32)},
                                              ("x",))
