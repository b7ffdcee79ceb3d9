"""The port's nested-jvp derivative path against paddlescience_tpu on the
CPU.

Both packages get the same MLP weights (``load_jax_params``) and the same
points, made with numpy from a seed. Tolerances (float32): derivative
components of orders 1-4 within 1e-5 of the JAX package's nested jvp,
relative to the component's largest magnitude, and their parameter
gradients within 1e-4 (relative norm); the jet and nested jvp on one stack
within 1e-5; composed expressions, ``TapeArray`` methods and the
functional ``jacobian_fn``/``hessian_fn`` within 1e-5; the Allen-Cahn and
2-D unsteady Navier-Stokes losses under the ``jvp`` candidate within 1e-5
of the jet path's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import ad as jad
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.solver.solver import _convert_expr
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch.arch.mlp import MLP as TMLP
from paddlescience_torch.autodiff import ad as tad
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.equation import AllenCahn as TAllenCahn
from paddlescience_torch.equation import NavierStokes as TNavierStokes
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

N, KEYS, OUTS = 24, ("t", "x", "y"), ("u", "v")


@pytest.fixture(autouse=True)
def _float32_and_paths(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _close(got, ref, rtol=1e-5):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _models(seed=3, layers=2, width=16, keys=KEYS, outs=OUTS):
    jm = psci.arch.MLP(keys, outs, num_layers=layers, hidden_size=width, activation="tanh", rngs=Rngs(seed))
    tm = TMLP(keys, outs, num_layers=layers, hidden_size=width, activation="tanh", device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    return jm, tm


def _points(seed=0, n=N, keys=KEYS):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32) for k in keys}


def _inputs(pts):
    return {k: jnp.asarray(v) for k, v in pts.items()}, {k: torch.from_numpy(v) for k, v in pts.items()}


def _rel_norm(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _grads(loss, model):
    """Parameter gradients, zeros for a parameter the loss does not reach
    (the output bias in a derivative), as ``jax.grad`` gives them."""
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _jax_component(jm, jinp, dmulti):
    params, rest = jm.param_tree(), jm.buffer_tree()
    w = jnp.asarray(np.random.default_rng(9).normal(size=(N, len(OUTS))).astype(np.float32))

    def comp(p):
        with jm.bind(p, rest), jad.tape_context() as tape:
            jexpr.forward_with_derivatives([jm], jinp, tape)
            return tape._stacks[0].get_component(dmulti)

    value = comp(params)
    grads = jax.grad(lambda p: jnp.sum(comp(p) * w))(params)
    return np.asarray(value), flatten_tree(jax.tree.map(np.asarray, grads)), np.asarray(w)


def _port_stack(tm, tinp, deriv):
    with tpath.override(tpath.CANDIDATES[deriv]), tad.tape_context() as tape:
        texpr.forward_with_derivatives([tm], tinp, tape)
    return tape._stacks[0]


DMULTIS = [(0,), (2,), (1, 1), (0, 2), (0, 1, 1), (2, 2, 2), (1, 1, 1, 1), (0, 1, 2, 2)]


@pytest.mark.parametrize("dmulti", DMULTIS, ids=lambda d: "d" + "".join("txy"[i] for i in d))
def test_component_and_its_gradient_match_jax(dmulti):
    """Orders 1-4, mixed too: the port's nested jvp (no jet on the stack)
    against the JAX package's, with the parameter gradient of a weighted
    sum of the component."""
    jm, tm = _models()
    jinp, tinp = _inputs(_points())
    j_val, j_grads, w = _jax_component(jm, jinp, dmulti)
    stack = _port_stack(tm, tinp, "jvp")
    assert stack.jet_fn is None
    t_val = stack.get_component(dmulti)
    _close(t_val, j_val)
    names = [n for n, _ in tm.named_parameters()]
    grads = _grads((t_val * torch.from_numpy(w.copy())).sum(), tm)
    assert set(names) == set(j_grads)
    for n, g in zip(names, grads):
        err = _rel_norm(g.numpy(), j_grads[n])
        assert err < 1e-4, f"{dmulti}: gradient of {n}: relative error {err:.2e}"


@pytest.mark.parametrize("deriv", ["jet", "jet_pallas_full"])
def test_jet_and_nested_jvp_agree_on_one_stack(deriv):
    """Order <= 2 on a stack with a jet: the jet's component against nested
    jvp of the same stack's point function."""
    _, tm = _models()
    _, tinp = _inputs(_points(1))
    dms = [(0,), (1,), (2,), (1, 1), (2, 2), (0, 1)]
    with tpath.override(tpath.CANDIDATES[deriv]):
        stack = _port_stack(tm, tinp, deriv)
        assert stack.jet_fn is not None
        stack.precompute(dms)
        for dm in dms:
            _close(stack.get_component(dm), tad._nested_jvp(stack.fn, stack.x, stack.extras, dm))


def test_orders_above_two_use_nested_jvp_on_a_jet_stack():
    """A third-order request on a jet stack goes to nested jvp, never to
    the jet forward."""
    _, tm = _models()
    _, tinp = _inputs(_points(2))
    stack = _port_stack(tm, tinp, "jet")
    calls = []
    jet_fn = stack.jet_fn
    stack.jet_fn = lambda x, dms: calls.append(dms) or jet_fn(x, dms)
    third = stack.get_component((1, 1, 1))
    assert calls == []
    _close(third, tad._nested_jvp(stack.fn, stack.x, {}, (1, 1, 1)))
    stack.get_component((1, 1))
    assert calls == [[(1, 1)]]


def _composed_exprs(ad):
    """Closures over each package's jacobian/hessian: composed TapeArrays,
    their methods, slicing and stop_gradient."""
    J, H = ad.jacobian, ad.hessian
    return {
        "j_uv": lambda o: J(o["u"] * o["v"], o["x"]),
        "h_uv": lambda o: H(o["u"] * o["v"] + 2.0, o["y"]),
        "j_tanh": lambda o: J((o["u"] * o["t"]).tanh(), o["t"]),
        "j_exp_sin": lambda o: J(o["u"].exp() + (2.0 * o["v"]).sin() - o["x"].cos(), o["x"]),
        "j_sqrt_abs": lambda o: J(abs(o["u"] - 3.0).sqrt(), o["y"]),
        "j_pow_div": lambda o: J(o["u"] ** 2 / 3.0 - 1.0 / (o["v"] + 4.0), o["t"]),
        "j_neg_rsub": lambda o: J(-(1.0 - o["u"] * o["y"]), o["y"]),
        "jj_of_record": lambda o: J(J(o["u"], o["x"]) * o["v"], o["x"]),
        "j_of_hessian": lambda o: J(H(o["u"], o["x"]), o["y"]),
        "j_stop": lambda o: J(ad.stop_gradient(o["u"]) * o["v"], o["x"]),
        "h_none": lambda o: H(o["u"] * o["t"], None, i=0, j=2),
    }


@pytest.mark.parametrize("deriv", ["jet", "jvp"])
def test_composed_expressions_match_jax(deriv):
    """``jacobian``/``hessian`` of composed TapeArrays and of records, the
    unary methods and ``stop_gradient``, against the JAX evaluator."""
    jm, tm = _models(5)
    jinp, tinp = _inputs(_points(3))
    with jpath.override(jpath.CANDIDATES["jet"]):
        jr = jexpr.evaluate_expressions([jm], jinp, _composed_exprs(jad))
    with tpath.override(tpath.CANDIDATES[deriv]):
        tr = texpr.evaluate_expressions([tm], tinp, _composed_exprs(tad))
    for name in _composed_exprs(tad):
        _close(tr[name], jr[name])


def test_composed_expression_gradient_matches_jax():
    jm, tm = _models(6)
    jinp, tinp = _inputs(_points(4))
    expr = {"r": lambda o, ad: ad.jacobian(o["u"] * o["v"], o["x"]) + ad.hessian(o["u"], o["y"])}
    params, rest = jm.param_tree(), jm.buffer_tree()

    def loss(p):
        with jm.bind(p, rest):
            r = jexpr.evaluate_expressions([jm], jinp, {"r": lambda o: expr["r"](o, jad)})["r"]
        return jnp.mean(r**2)

    with jpath.override(jpath.CANDIDATES["jet"]):
        j_grads = flatten_tree(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    with tpath.override(tpath.CANDIDATES["jvp"]):
        r = texpr.evaluate_expressions([tm], tinp, {"r": lambda o: expr["r"](o, tad)})["r"]
    grads = _grads((r**2).mean(), tm)
    for (n, _), g in zip(tm.named_parameters(), grads):
        assert _rel_norm(g.numpy(), j_grads[n]) < 1e-4, n


def test_tape_array_slicing_and_comparisons():
    """Slicing and comparisons give plain tensors (as in the JAX package),
    a slice of a derivative is that derivative's rows."""
    _, tm = _models()
    _, tinp = _inputs(_points(5))
    seen = {}

    def probe(o):
        u = o["u"]
        seen["u0"] = u[0:1]
        seen["ux1"] = tad.jacobian(u, o["x"])[1:2]
        seen["cmp"] = (u < 0.0, u >= o["v"], u > 0.1, u <= 0.1)
        seen["shape"] = (u.shape, u.ndim, u.dtype)
        return u

    with tpath.override(tpath.CANDIDATES["jet"]):
        texpr.evaluate_expressions([tm], tinp, {"u": probe})
        stack = _port_stack(tm, tinp, "jet")
    u = tm(tinp)["u"]
    assert isinstance(seen["u0"], torch.Tensor) and not isinstance(seen["u0"], tad.TapeArray)
    _close(seen["u0"], u[0:1].detach().numpy())
    _close(seen["ux1"], stack.get_component((1,))[1:2, 0:1].detach().numpy())
    for mask in seen["cmp"]:
        assert isinstance(mask, torch.Tensor) and mask.dtype == torch.bool and mask.shape == (N, 1)
    assert seen["shape"] == (torch.Size([N, 1]), 2, torch.float32)


def test_mixing_with_a_batched_tensor_gives_a_plain_result():
    """As in the JAX package: a TapeArray times a batched tensor is a plain
    tensor, and its jacobian raises (not on the tape)."""
    _, tm = _models()
    _, tinp = _inputs(_points(6))
    w = torch.rand(N, 1)
    expr = {"r": lambda o: tad.jacobian(o["u"] * w, o["x"])}
    with tpath.override(tpath.CANDIDATES["jvp"]), pytest.raises(ValueError, match="not on the autodiff tape"):
        texpr.evaluate_expressions([tm], tinp, expr)


def test_jacobian_fn_and_hessian_fn_match_jax():
    def jf(x):
        return jnp.stack([jnp.sin(x[0]) * x[1] ** 2, jnp.exp(x[1]) * x[0]])

    def tf(x):
        return torch.stack([torch.sin(x[0]) * x[1] ** 2, torch.exp(x[1]) * x[0]])

    x = np.random.default_rng(7).uniform(-1, 1, (5, 2)).astype(np.float32)
    _close(tad.jacobian_fn(tf)(torch.from_numpy(x)), jad.jacobian_fn(jf)(jnp.asarray(x)))
    _close(tad.hessian_fn(tf)(torch.from_numpy(x)), jad.hessian_fn(jf)(jnp.asarray(x)))


def test_clear_drops_cached_components():
    _, tm = _models()
    _, tinp = _inputs(_points(7))
    with tpath.override(tpath.CANDIDATES["jvp"]), tad.tape_context() as tape:
        out = texpr.forward_with_derivatives([tm], tinp, tape)
        first = tad.jacobian(out["u"], out["x"])
        assert tape._stacks[0]._components and tape.lookup(first) is not None
        tad.clear()
        assert not tape._stacks[0]._components and tape.lookup(first) is None
    with pytest.raises(RuntimeError, match="No active autodiff tape"):
        tad.jacobian(first, first)


def test_per_point_extras_ride_along():
    """A model with a coordinate column and a per-point extra (an (N, 2)
    input): its derivatives by nested jvp, the extra held constant, against
    torch.autograd on the plain forward."""

    class WithExtra(torch.nn.Module):
        input_keys, output_keys = ("x", "f"), ("u",)

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(3, 8, generator=torch.Generator().manual_seed(0)))

        def forward(self, d):
            h = torch.tanh(torch.cat([d["x"], d["f"]], -1) @ self.w)
            return {"u": (h * h.roll(1, -1)).sum(-1, keepdim=True)}

        def supports_jet(self):
            return False

    model = WithExtra()
    x = torch.rand(N, 1)
    f = torch.rand(N, 2)
    exprs = {"u_xx": lambda o: tad.hessian(o["u"], o["x"]), "u_xxx": lambda o: tad.jacobian(
        tad.jacobian(tad.jacobian(o["u"], o["x"]), o["x"]), o["x"])}
    got = texpr.evaluate_expressions([model], {"x": x, "f": f}, exprs)
    xr = x.clone().requires_grad_()
    d = model({"x": xr, "f": f})["u"]
    ref = []
    for _ in range(3):
        d = torch.autograd.grad(d.sum(), xr, create_graph=True)[0]
        ref.append(d)
    _close(got["u_xx"], ref[1].detach().numpy())
    _close(got["u_xxx"], ref[2].detach().numpy())


def _pde_loss(tm, tinp, eqs, deriv):
    with tpath.override(tpath.CANDIDATES[deriv]):
        res = texpr.evaluate_expressions([tm], tinp, eqs)
    loss = sum((res[k] ** 2).mean() for k in eqs)
    return loss, _grads(loss, tm)


@pytest.mark.parametrize("case", ["allen_cahn", "navier_stokes_2d_unsteady"])
def test_pde_losses_under_jvp_match_the_jet_path(case):
    """The PDE loss and its parameter gradient under the ``jvp`` candidate
    against the jet path, and both residuals against the JAX package's."""
    if case == "allen_cahn":
        keys, outs, eqs, jeqs = ("t", "x"), ("u",), TAllenCahn(0.01).equations, psci.equation.AllenCahn(0.01).equations
    else:
        keys, outs = KEYS, ("u", "v", "p")
        eqs = TNavierStokes(0.02, 1.0, 2, True).equations
        jeqs = psci.equation.NavierStokes(0.02, 1.0, 2, True).equations
    jm, tm = _models(8, 3, 24, keys, outs)
    jinp, tinp = _inputs(_points(8, 64, keys))
    l_jvp, g_jvp = _pde_loss(tm, tinp, eqs, "jvp")
    l_jet, g_jet = _pde_loss(tm, tinp, eqs, "jet")
    _close(l_jvp, l_jet.detach().numpy())
    for a, b in zip(g_jvp, g_jet):
        assert _rel_norm(a.numpy(), b.numpy()) < 1e-5
    with jpath.override(jpath.CANDIDATES["jvp"]):
        jr = jexpr.evaluate_expressions([jm], jinp, _convert_expr(jeqs))
    with tpath.override(tpath.CANDIDATES["jvp"]):
        tr = texpr.evaluate_expressions([tm], tinp, eqs)
    for k in eqs:
        _close(tr[k], jr[k])
