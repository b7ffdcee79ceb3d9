"""The port's Volterra and FractionalPoisson equations against
paddlescience_tpu on the CPU.

Both packages build their quadrature matrices on the host from the same
collocation points: the matrices and the extended point sets agree within
1e-6 relative (bitwise in practice). From the same MLP weights, the
residuals agree within 1e-5 relative to their largest magnitude and
their parameter gradients within 1e-4, and the Volterra residual is held
next to JAX ``tests/test_equation_oracles.py``'s dense trapezoid oracle.
The matrix lives on the device the caller names, once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import jacobian as jjacobian
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch import equation as tequation
from paddlescience_torch.arch.mlp import MLP as TMLP
from paddlescience_torch.autodiff import ad as tad
from paddlescience_torch.geometry.geometry_2d import Disk
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _models(keys, seed=2, width=12):
    jm = psci.arch.MLP(keys, ("u",), 2, width, rngs=Rngs(seed))
    tm = TMLP(keys, ("u",), 2, width, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    return jm, tm


def _residual_and_grads(jm, tm, jeq, teq, name, inputs):
    """The residual ``name`` through both packages, within 1e-5 of its
    largest magnitude, and the parameter gradients of its mean square
    within 1e-4."""

    def jloss(p):
        with jm.bind(p, jm.buffer_tree()):
            r = jexpr.evaluate_expressions([jm], {k: jnp.asarray(v) for k, v in inputs.items()},
                                           {name: jeq.equations[name]})[name]
        return jnp.mean(r**2), r

    (_, j_res), j_grads = jax.value_and_grad(jloss, has_aux=True)(jm.param_tree())
    t_res = texpr.evaluate_expressions([tm], {k: torch.from_numpy(v) for k, v in inputs.items()},
                                       {name: teq.equations[name]})[name]
    _close(t_res, j_res, 1e-5)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((t_res**2).mean(), list(named.values()), allow_unused=True)
    j_grads = flatten_tree(jax.tree.map(np.asarray, j_grads))
    for (n, p), g in zip(named.items(), grads):
        _close(torch.zeros_like(p) if g is None else g, j_grads[n], 1e-4)
    return t_res


def _volterras(num_points):
    kernel = lambda t, s: np.exp(s - t)
    jeq = psci.equation.Volterra(0.0, num_points, 20, kernel, lambda out: jjacobian(out["u"], out["x"]) + out["u"])
    teq = tequation.Volterra(0.0, num_points, 20, kernel, lambda out: tad.jacobian(out["u"], out["x"]) + out["u"])
    return jeq, teq


@pytest.mark.parametrize("t1", [2.0, 5.0])
def test_volterra_matrix_and_points_match_jax(t1):
    jeq, teq = _volterras(12)
    x_col = np.linspace(0, t1, 12, dtype=np.float32)
    j_full, t_full = jeq.precompute(x_col), teq.precompute(x_col, device="cpu")
    assert t_full.dtype == np.float32 and t_full.shape == (12 + 12 * 20, 1)
    _close(t_full, j_full, 1e-6)
    assert teq._int_mat.device.type == "cpu" and teq._int_mat.dtype == torch.float32
    _close(teq._int_mat, jeq._int_mat, 1e-6)


def test_volterra_residual_matches_jax_and_the_trapezoid_oracle():
    num_points = 8
    jeq, teq = _volterras(num_points)
    jm, tm = _models(("x",))
    x_col = np.linspace(0.1, 2.0, num_points, dtype=np.float32)
    full_x = teq.precompute(x_col, device="cpu")
    jeq.precompute(x_col)
    res = _residual_and_grads(jm, tm, jeq, teq, "volterra", {"x": full_x}).detach().numpy()
    assert res.shape == (num_points, 1)
    # the oracle of the JAX test: u' + u - int_0^x e^(s - x) u(s) ds by a dense trapezoid
    with torch.no_grad():
        u_of = lambda x: tm({"x": torch.from_numpy(np.asarray(x, np.float32).reshape(-1, 1))})["u"].detach().numpy()[:, 0]
        h = 1e-3
        du = (u_of(x_col + h) - u_of(x_col - h)) / (2 * h)
        integ = np.array([np.trapezoid(np.exp(s - xv) * u_of(s), s)
                          for xv in x_col for s in [np.linspace(0, xv, 800, dtype=np.float32)]])
    np.testing.assert_allclose(res[:, 0], du + u_of(x_col) - integ, rtol=5e-2, atol=5e-3)


def test_volterra_needs_precompute():
    _, teq = _volterras(4)
    _, tm = _models(("x",))
    with pytest.raises(RuntimeError, match="precompute"):
        texpr.evaluate_expressions([tm], {"x": torch.rand(4, 1)}, {"v": teq.equations["volterra"]})


def _fpdes(resolution):
    geom_j, geom_t = psci.geometry.Disk((0, 0), 1), Disk((0, 0), 1)
    return (psci.equation.FractionalPoisson(1.8, geom_j, resolution),
            tequation.FractionalPoisson(1.8, geom_t, resolution))


def _disk_points(n, seed=0):
    rng = np.random.default_rng(seed)
    r, th = 0.9 * np.sqrt(rng.uniform(size=n)), rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th)], 1).astype(np.float32)


@pytest.mark.parametrize("resolution", [(8, 40), (5, 7)])
def test_fractional_poisson_matrix_and_points_match_jax(resolution):
    jeq, teq = _fpdes(resolution)
    xy = _disk_points(20)
    j_full, t_full = jeq.precompute(xy), teq.precompute(xy, device="cpu")
    n_theta, n_r = resolution
    assert t_full.shape == (20 + 20 * n_theta * n_r, 2) and t_full.dtype == np.float32
    _close(t_full, j_full, 1e-6)
    assert teq._int_mat.shape == (20, len(t_full)) and teq._int_mat.dtype == torch.float32
    _close(teq._int_mat, jeq._int_mat, 1e-6)
    assert teq._c_norm == jeq._c_norm


def test_fractional_poisson_residual_matches_jax():
    """Both closures on the same u (seeded, on the extended points): the
    residual within 1e-5 and its gradient in u within 1e-4. (Through two
    nets the GL sums, which cancel terms some 300x the residual, magnify
    the nets' own 1e-7 float32 differences to ~3e-5: the example's train
    steps hold the whole path.)"""
    jeq, teq = _fpdes((8, 10))
    xy = _disk_points(16, seed=3)
    full = teq.precompute(xy, device="cpu")
    jeq.precompute(xy)
    u = np.random.default_rng(6).uniform(-1, 1, (len(full), 1)).astype(np.float32)
    cols = {"x": full[:, :1], "y": full[:, 1:]}

    def jloss(uu):
        r = jeq.equations["fpde"]({"u": uu, **{k: jnp.asarray(v) for k, v in cols.items()}})
        return jnp.mean(r**2), r

    (_, j_res), j_du = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(u))
    tu = torch.from_numpy(u).requires_grad_(True)
    t_res = teq.equations["fpde"]({"u": tu, **{k: torch.from_numpy(v) for k, v in cols.items()}})
    assert t_res.shape == (16, 1)
    _close(t_res, j_res, 1e-5)
    _close(torch.autograd.grad((t_res**2).mean(), tu)[0], j_du, 1e-4)
    # through the solver's evaluation of a net, with the matrix on the CPU
    _, tm = _models(("x", "y"), seed=5)
    out = texpr.evaluate_expressions([tm], {k: torch.from_numpy(v) for k, v in cols.items()},
                                     {"fpde": teq.equations["fpde"]})["fpde"]
    assert out.shape == (16, 1) and torch.isfinite(out).all()


def test_fractional_poisson_exact_solution_has_a_small_residual():
    """On u = (1 - |x|^2)^(1 + alpha / 2) the GL residual is small against
    the right-hand side (the discretisation's own error)."""
    _, teq = _fpdes((16, 200))
    xy = _disk_points(12, seed=4) * 0.5
    full = teq.precompute(xy, device="cpu")
    u = np.abs(1 - (full**2).sum(1, keepdims=True)) ** (1 + 0.9)
    out = {"u": torch.from_numpy(u.astype(np.float32)), "x": torch.from_numpy(full[:, :1]),
           "y": torch.from_numpy(full[:, 1:])}
    res = teq.equations["fpde"](out).numpy()[:, 0]
    from scipy.special import gamma

    rhs = 2**1.8 * gamma(2 + 0.9) * gamma(1 + 0.9) * (1 - 1.9 * (xy**2).sum(1))
    assert np.abs(res).max() < 0.05 * np.abs(rhs).max()
