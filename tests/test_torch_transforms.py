"""Arch input and output transforms of the port against paddlescience_tpu
on the CPU.

Both packages get the same weights (``utils/jax_params.py``), the same
points (numpy, seeded) and the same transforms (written with arithmetic
only, so one function serves both). Tolerances (float32): forwards of the
transformed MLP (also with a period embedding), ModifiedMLP (whose output
transform sees the inputs before the input transform), PirateNet and
DeepONet within 1e-6 relative; derivative components within 1e-5 of the
largest magnitude and parameter gradients within 1e-4, through nested jvp
on both sides. The stream-function transform (u = psi_y, v = -psi_x, then
a Poisson on p through the derived stack), the input-transform key remap
(a net fed the x-derivatives of another), renamed outputs and the
pass-through of a non-coordinate model's outputs: within 1e-5. A
transformed net has no jet forward and no kernel candidate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import ad as jad
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch.arch import mlp as tmlp
from paddlescience_torch.arch.deeponet import DeepONet as TDeepONet
from paddlescience_torch.arch.model_list import ModelList as TModelList
from paddlescience_torch.autodiff import ad as tad
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver import autotune
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

from _mlp_parity import WIDTH, check_against_jax, close, pair, points


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def t_in(x):
    return {"x": 2.0 * x["x"] - 0.5, "y": x["y"] * x["y"]}


def t_out(x, y):
    return {"u": x["x"][..., :1] * y["u"] + x["y"], "v": y["v"] * (1.0 - x["y"] * x["y"])}


CASES = {
    "mlp": (psci.arch.MLP, tmlp.MLP, dict(num_layers=3, hidden_size=WIDTH)),
    "mlp_periods": (psci.arch.MLP, tmlp.MLP, dict(num_layers=2, hidden_size=WIDTH, periods={"x": (2.0, False)})),
    "modified_mlp": (psci.arch.ModifiedMLP, tmlp.ModifiedMLP, dict(num_layers=3, hidden_size=WIDTH)),
    "piratenet": (psci.arch.PirateNet, tmlp.PirateNet,
                  dict(num_blocks=2, hidden_size=WIDTH, fourier={"dim": WIDTH, "scale": 1.0})),
}
TRANSFORMS = {"input": (t_in, None), "output": (None, t_out), "both": (t_in, t_out)}


def _register(model, fin, fout):
    if fin is not None:
        model.register_input_transform(fin)
    if fout is not None:
        model.register_output_transform(fout)


@pytest.mark.parametrize("which", list(TRANSFORMS))
@pytest.mark.parametrize("case", list(CASES))
def test_transformed_net_matches_jax(case, which):
    """The forward of the nets as built (the JAX initialisation carried
    over) within 1e-6; with both transforms, also the derivatives and
    gradients of the nets with every parameter nudged (PirateNet's alpha
    off 0) within 1e-5 / 1e-4."""
    jcls, tcls, kw = CASES[case]
    jm = jcls(("x", "y"), ("u", "v"), rngs=Rngs(3), **kw)
    tm = tcls(("x", "y"), ("u", "v"), device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    for m in (jm, tm):
        _register(m, *TRANSFORMS[which])
    assert not tm.supports_jet() and not tm.jet_pallas_eligible()
    pts = points()
    j_out = jm({k: jnp.asarray(v) for k, v in pts.items()})
    t_out_ = tm({k: torch.from_numpy(v) for k, v in pts.items()})
    assert set(t_out_) == set(j_out) == {"u", "v"}
    for k in j_out:
        close(t_out_[k], j_out[k], 1e-6)
    if which != "both":
        return
    jm, params, rest, tm = pair(jcls, tcls, kw)
    for m in (jm, tm):
        _register(m, *TRANSFORMS[which])
    check_against_jax(jm, params, rest, tm, forward=False)


def test_modified_mlp_hands_the_given_inputs_to_its_output_transform():
    """The JAX ``x_identity`` quirk: ModifiedMLP's output transform sees the
    inputs as given, MLP's the transformed ones."""
    seen = {}

    def record(name):
        def fout(x, y):
            seen[name] = x["x"]
            return y
        return fout

    xs = {"x": torch.full((3, 1), 0.25), "y": torch.full((3, 1), 0.5)}
    for name, cls in (("mlp", tmlp.MLP), ("modified_mlp", tmlp.ModifiedMLP)):
        m = cls(("x", "y"), ("u", "v"), 2, 8, device="cpu")
        _register(m, t_in, record(name))
        m(xs)
    assert torch.equal(seen["modified_mlp"], xs["x"]) and torch.equal(seen["mlp"], 2.0 * xs["x"] - 0.5)


def test_deeponet_transforms_match_jax():
    jm = psci.arch.DeepONet("u", "y", "G", 20, 8, 2, 2, 16, 16, rngs=Rngs(4))
    tm = TDeepONet("u", "y", "G", 20, 8, 2, 2, 16, 16, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    fin = lambda x: {"u": 0.5 * x["u"], "y": x["y"] + 1.0}
    fout = lambda x, y: {"G": x["y"] * y["G"]}
    for m in (jm, tm):
        _register(m, fin, fout)
    rng = np.random.default_rng(1)
    inputs = {"u": rng.standard_normal((17, 20)).astype(np.float32), "y": rng.uniform(size=(17, 1)).astype(np.float32)}

    def jloss(p):
        with jm.bind(p, jm.buffer_tree()):
            g = jm({k: jnp.asarray(v) for k, v in inputs.items()})["G"]
        return jnp.mean(g**2), g

    (_, j_g), j_grads = jax.value_and_grad(jloss, has_aux=True)(jm.param_tree())
    t_g = tm({k: torch.from_numpy(v) for k, v in inputs.items()})["G"]
    close(t_g, j_g, 1e-6)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((t_g**2).mean(), list(named.values()))
    j_grads = flatten_tree(jax.tree.map(np.asarray, j_grads))
    for (n, _), g in zip(named.items(), grads):
        close(g, j_grads[n], 1e-5)


def _jax_torch_mlp(keys, outs, layers=2, width=12, seed=3, **kw):
    jm = psci.arch.MLP(keys, outs, layers, width, rngs=Rngs(seed), **kw)
    tm = tmlp.MLP(keys, outs, layers, width, device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    return jm, tm


def _evaluate_both(jmodels, tmodels, pts, exprs_of, zero=()):
    """Every expression of ``exprs_of(ad)`` through both packages, within
    1e-5 (those in ``zero``, identically 0, within 1e-6 of 0 in both)."""
    j_res = jexpr.evaluate_expressions(jmodels, {k: jnp.asarray(v) for k, v in pts.items()}, exprs_of(jad))
    t_res = texpr.evaluate_expressions(tmodels, {k: torch.from_numpy(v) for k, v in pts.items()}, exprs_of(tad))
    for k in exprs_of(tad):
        if k in zero:
            for v in (np.asarray(j_res[k]), t_res[k].detach().numpy()):
                np.testing.assert_allclose(v, 0.0, atol=1e-6)
        else:
            close(t_res[k], j_res[k], 1e-5)
    return j_res, t_res


def _jax_grads(jmodels, pts, exprs_of, names):
    trees = [m.param_tree() for m in jmodels]

    def loss(ps):
        ctx = [m.bind(p, m.buffer_tree()) for m, p in zip(jmodels, ps)]
        for c in ctx:
            c.__enter__()
        try:
            res = jexpr.evaluate_expressions(jmodels, {k: jnp.asarray(v) for k, v in pts.items()}, exprs_of(jad))
            return sum(jnp.mean(res[n] ** 2) for n in names)
        finally:
            for c in reversed(ctx):
                c.__exit__(None, None, None)

    return [flatten_tree(jax.tree.map(np.asarray, g)) for g in jax.grad(loss)(trees)]


def _check_grads(tmodels, t_res, j_grads, names):
    params = [p for m in tmodels for p in m.parameters()]
    grads = torch.autograd.grad(sum((t_res[n] ** 2).mean() for n in names), params, allow_unused=True)
    it = iter(grads)
    for m, jg in zip(tmodels, j_grads):
        for n, p in m.named_parameters():
            g = next(it)
            close(torch.zeros_like(p) if g is None else g, jg[n], 1e-4)


def stream_exprs(ad):
    def d(f, k):
        return ad.jacobian(f, k)

    return {
        "u": lambda o: ad.unwrap(o["u"]),
        "v": lambda o: ad.unwrap(o["v"]),
        "div": lambda o: ad.unwrap(d(o["u"], o["x"]) + d(o["v"], o["y"])),
        "u_x": lambda o: ad.unwrap(d(o["u"], o["x"])),
        "u_xy": lambda o: ad.unwrap(d(d(o["u"], o["x"]), o["y"])),
        "p_x": lambda o: ad.unwrap(d(o["p"], o["x"])),
        "p_xx": lambda o: ad.unwrap(d(d(o["p"], o["x"]), o["x"])),
        "p_yy": lambda o: ad.unwrap(ad.hessian(o["p"], o["y"])),
    }


def _stream_transform(ad):
    def transform_out(in_, out):
        return {"u": ad.jacobian(out["psi"], in_["y"]), "v": -ad.jacobian(out["psi"], in_["x"]), "p": out["p_raw"]}

    return transform_out


def test_stream_function_transform_matches_jax():
    """JAX ``tests/test_autodiff.py``'s stream-function case: the transform
    calls ``jacobian``, its outputs form a derived stack, and the equations
    differentiate u, v and p again."""
    jm, tm = _jax_torch_mlp(("x", "y"), ("psi", "p_raw"))
    jm.register_output_transform(_stream_transform(jad))
    tm.register_output_transform(_stream_transform(tad))
    rng = np.random.default_rng(5)
    pts = {k: rng.uniform(0, 1, (16, 1)).astype(np.float32) for k in ("x", "y")}
    _, t_res = _evaluate_both([jm], [tm], pts, stream_exprs, zero=("div",))
    names = ("u_x", "u_xy", "p_xx", "p_yy")
    _check_grads([tm], t_res, _jax_grads([jm], pts, stream_exprs, names), names)


def test_stream_function_in_a_model_list_and_predict():
    """bubble's layout: the stream-function child of a ModelList beside an
    untransformed one; the solver's predict returns the renamed outputs."""
    _, psi = _jax_torch_mlp(("x", "y"), ("psi", "p_raw"))
    _, phil = _jax_torch_mlp(("x", "y"), ("phil",), seed=4)
    psi.register_output_transform(_stream_transform(tad))
    model = TModelList((psi, phil))
    assert set(model.output_keys) == {"psi", "p_raw", "phil"}
    rng = np.random.default_rng(2)
    inp = {k: rng.uniform(0, 1, (8, 1)).astype(np.float32) for k in ("x", "y")}
    sup = SupervisedConstraint({"dataset": {"name": "IterableNamedArrayDataset", "input": inp,
                                            "label": {"phil": np.zeros((8, 1), np.float32)}}},
                               MSELoss("mean"), {"phil": lambda out: out["phil"]}, name="Sup")
    solver = Solver(model, {"Sup": sup}, None, Adam(1e-3)(model), epochs=1, iters_per_epoch=1, device="cpu")
    pred = solver.predict(inp, return_numpy=True)
    assert set(pred) == {"u", "v", "p", "phil"}
    exprs = stream_exprs(tad)
    ref = texpr.evaluate_expressions([psi], {k: torch.from_numpy(v) for k, v in inp.items()},
                                     {"u": exprs["u"], "v": exprs["v"]})
    for k in ("u", "v"):
        np.testing.assert_array_equal(pred[k], ref[k].detach().numpy())
    assert autotune.candidate_names(solver) == ["jvp", "jet"]  # phil keeps its jet


def _deriv_features(ad_unwrap, jvp):
    """(t, x) -> (u, u_x, u_xx) of ``u_model`` by nested jvp, the deephpms
    input transform, with the framework's ``jvp``."""

    def make(u_model):
        def transform(in_):
            t, x = ad_unwrap(in_["t"]), ad_unwrap(in_["x"])
            f = lambda xx: u_model({"t": t, "x": xx})["u_idn"]
            ones = x * 0.0 + 1.0
            u, ux = jvp(f, (x,), (ones,))
            uxx = jvp(lambda xx: jvp(f, (xx,), (ones,))[1], (x,), (ones,))[1]
            return {"u_x": u, "du_x": ux, "du_xx": uxx}

        return transform

    return make


def remap_exprs(ad):
    return {"du_t": lambda o: ad.unwrap(ad.jacobian(o["u_idn"], o["t"])), "f_pde": lambda o: ad.unwrap(o["f_pde"])}


def test_input_transform_key_remap_matches_jax():
    """deephpms's layout: the PDE net's inputs are u and its x-derivatives,
    which its input transform takes from the identification net by nested
    jvp, so the constraint's (t, x) feed it and it is differentiated along
    them."""
    j_idn, t_idn = _jax_torch_mlp(("t", "x"), ("u_idn",), activation="sin")
    j_pde, t_pde = _jax_torch_mlp(("u_x", "du_x", "du_xx"), ("f_pde",), width=16, seed=7, activation="sin")
    norm = lambda x: {"t": 0.2 * x["t"] - 1.0, "x": 0.125 * x["x"]}
    for m in (j_idn, t_idn):
        m.register_input_transform(norm)
    j_pde.register_input_transform(_deriv_features(jad.unwrap, jax.jvp)(j_idn))
    t_pde.register_input_transform(_deriv_features(tad.unwrap, torch.func.jvp)(t_idn))
    rng = np.random.default_rng(8)
    pts = {"t": rng.uniform(0, 10, (16, 1)).astype(np.float32), "x": rng.uniform(-8, 8, (16, 1)).astype(np.float32)}
    _, t_res = _evaluate_both([j_idn, j_pde], [t_idn, t_pde], pts, remap_exprs)
    names = ("du_t", "f_pde")
    _check_grads([t_idn, t_pde], t_res, _jax_grads([j_idn, j_pde], pts, remap_exprs, names), names)
    # through a ModelList the PDE net gets every given input as well
    merged = TModelList((t_idn, t_pde))({k: torch.from_numpy(v) for k, v in pts.items()})
    np.testing.assert_array_equal(merged["f_pde"].detach().numpy(), t_res["f_pde"].detach().numpy())


def rename_exprs(ad):
    return {"w": lambda o: ad.unwrap(o["w"]), "w_x": lambda o: ad.unwrap(ad.jacobian(o["w"], o["x"])),
            "w_yy": lambda o: ad.unwrap(ad.hessian(o["w"], o["y"])), "h": lambda o: o["h"]}


def test_renamed_and_non_coordinate_outputs_match_jax():
    """A coordinate model whose output transform renames u to w goes on the
    tape (w is differentiated); a model with no (N, 1) input passes its
    renamed outputs through."""
    jm, tm = _jax_torch_mlp(("x", "y"), ("u",))
    jg, tg = _jax_torch_mlp(("a",), ("g",), seed=9, input_dim=3)
    rename = lambda x, y: {"w": x["x"] * y["u"]}
    for m in (jm, tm):
        m.register_output_transform(rename)
    for m in (jg, tg):
        m.register_output_transform(lambda x, y: {"h": 2.0 * y["g"]})
    rng = np.random.default_rng(3)
    pts = {"x": rng.uniform(0, 1, (12, 1)).astype(np.float32), "y": rng.uniform(0, 1, (12, 1)).astype(np.float32),
           "a": rng.standard_normal((12, 3)).astype(np.float32)}
    _, t_res = _evaluate_both([jm, jg], [tm, tg], pts, rename_exprs)
    names = ("w_x", "w_yy", "h")
    _check_grads([tm, tg], t_res, _jax_grads([jm, jg], pts, rename_exprs, names), names)


def test_plain_transform_sits_inside_the_nested_jvp_point_function():
    """w = x (1 - x) u: the tape's d w / dx is (1 - 2x) u + x (1 - x) u_x,
    with u and u_x those of the raw net."""
    _, tm = _jax_torch_mlp(("x", "y"), ("u",))
    rng = np.random.default_rng(4)
    pts = {k: torch.from_numpy(rng.uniform(0, 1, (10, 1)).astype(np.float32)) for k in ("x", "y")}
    raw = texpr.evaluate_expressions([tm], pts, {"u": lambda o: o["u"], "u_x": lambda o: tad.jacobian(o["u"], o["x"])})
    tm.register_output_transform(lambda i, o: {"u": i["x"] * (1.0 - i["x"]) * o["u"]})
    got = texpr.evaluate_expressions([tm], pts, {"w_x": lambda o: tad.jacobian(o["u"], o["x"])})["w_x"]
    x = pts["x"]
    want = (1 - 2 * x) * raw["u"] + x * (1 - x) * raw["u_x"]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_transformed_nets_never_reach_a_kernel():
    nets = [tmlp.MLP(("x", "y"), ("u",), 2, 8, device="cpu"),
            tmlp.ModifiedMLP(("x", "y"), ("u",), 2, 8, device="cpu"),
            tmlp.PirateNet(("x", "y"), ("u",), 1, 2, device="cpu")]
    tpath.set_default(tpath.CANDIDATES["jet_pallas_full"])
    for i, m in enumerate(nets):
        assert m.supports_jet() and m.jet_pallas_eligible()
        _register(m, *((t_in, None), (None, t_out), (t_in, t_out))[i])
        assert not m.supports_jet() and not m.jet_pallas_eligible() and m.jet_segment_lengths() == []
        with pytest.raises(ValueError, match="no jet forward"):
            m.forward_jet(None)
    inp = {k: np.linspace(0, 1, 8, dtype=np.float32).reshape(-1, 1) for k in ("x", "y")}
    sup = SupervisedConstraint({"dataset": {"name": "IterableNamedArrayDataset", "input": inp,
                                            "label": {"u": np.zeros((8, 1), np.float32)}}},
                               MSELoss("mean"), {"u": lambda out: tad.jacobian(out["u"], out["x"])}, name="Sup")
    model = nets[0]
    solver = Solver(model, {"Sup": sup}, None, Adam(1e-3)(model), epochs=1, iters_per_epoch=1, device="cpu")
    assert autotune.candidate_names(solver) == ["jvp"]
    assert texpr._collect_jet_requests(solver.models, {k: torch.from_numpy(v) for k, v in inp.items()},
                                       sup.output_expr) is None
    logs = solver.train_step()
    assert np.isfinite(float(logs["loss"]))


def test_tape_transform_is_detected_once_per_registered_transform(monkeypatch):
    """The failing plain call that shows a derivative-taking transform runs
    once; registering another transform asks again."""
    _, tm = _jax_torch_mlp(("x", "y"), ("psi", "p_raw"))
    tm.register_output_transform(_stream_transform(tad))
    calls = []
    forward = tmlp.MLP.forward
    monkeypatch.setattr(tmlp.MLP, "forward", lambda self, x: calls.append(1) or forward(self, x))
    pts = {k: torch.rand(4, 1) for k in ("x", "y")}
    exprs = {"u": lambda o: o["u"]}
    texpr.evaluate_expressions([tm], pts, exprs)
    first = len(calls)
    texpr.evaluate_expressions([tm], pts, exprs)
    assert len(calls) - first == first - 1  # the detecting call is not repeated
    tm.register_output_transform(lambda i, o: {"u": o["psi"], "p": o["p_raw"]})
    out = texpr.evaluate_expressions([tm], pts, {"u_x": lambda o: tad.jacobian(o["u"], o["x"])})
    assert out["u_x"].shape == (4, 1)
