"""Shared comparison of the MLP-family tests (``test_torch_mlp_family.py``,
``test_torch_parametric_activations.py``): a JAX net and the port's built
alike, every parameter nudged by a seeded amount (the constants too:
PirateNet's alpha, weight-norm gains, Stan/Swish beta) so that it matters
and loaded into the port's net through ``utils/jax_params.py``; then, on
128 points from a numpy seed, the outputs within 1e-5, the derivative
components u_x, u_y, u_xx, u_yy, u_xy (and v's) within 1e-5 of the largest
magnitude, and the parameter gradient of their mean square within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddlescience_tpu.autodiff import ad as jad
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch.autodiff import ad as tad
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

N, WIDTH = 128, 16
NAMES = ["u_x", "u_y", "u_xx", "u_yy", "u_xy", "v_x", "v_y", "v_xx", "v_yy", "v_xy"]


def close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _nudged(params, seed):
    """Every parameter moved by a seeded amount (the constants too)."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.tree.map(np.asarray, params))
    return {k: (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in flat.items()}


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def pair(jcls, tcls, kw):
    """(JAX net, its nudged parameters, its buffers, the port's net with
    the same values)."""
    jm = jcls(("x", "y"), ("u", "v"), rngs=Rngs(3), **kw)
    flat = _nudged(jm.param_tree(), 5)
    params, rest = _unflatten(flat), jm.buffer_tree()
    tm = tcls(("x", "y"), ("u", "v"), device="cpu", **kw)
    load_jax_params(tm, flat, jax.tree.map(np.asarray, rest))
    return jm, params, rest, tm


def _derivs(ad, names):
    """Expressions for the derivative components ``names`` ("u_xy", ...)
    through the tape of ``ad`` (either package's autodiff module)."""
    rules = {"x": lambda f, o: ad.jacobian(f, o["x"]), "y": lambda f, o: ad.jacobian(f, o["y"]),
             "xx": lambda f, o: ad.hessian(f, o["x"]), "yy": lambda f, o: ad.hessian(f, o["y"]),
             "xy": lambda f, o: ad.jacobian(ad.jacobian(f, o["x"]), o["y"])}
    return {n: (lambda out, c=n.split("_")[0], d=n.split("_")[1]: rules[d](out[c], out)) for n in names}


def points():
    rng = np.random.default_rng(11)
    return {k: rng.uniform(-1, 1, (N, 1)).astype(np.float32) for k in ("x", "y")}


def check_against_jax(jm, params, rest, tm, names=NAMES, port_path="jet", forward=True):
    """JAX's plain jet path (one jitted value-and-gradient, the forward
    with it) against the port's ``port_path``: the outputs (``forward``),
    the components ``names`` and the parameter gradients."""
    pts = points()

    def jloss(p):
        with jm.bind(p, rest):
            inputs = {k: jnp.asarray(v) for k, v in pts.items()}
            d = jexpr.evaluate_expressions([jm], inputs, _derivs(jad, names))
            out = jm(inputs) if forward else {}
        return sum(jnp.mean(d[n] ** 2) for n in names), (d, out)

    with jpath.override(jpath.CANDIDATES["jet"]):
        (_, (j_d, j_out)), j_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    if forward:
        t_out = tm({k: torch.from_numpy(v) for k, v in pts.items()})
        for c in ("u", "v"):
            close(t_out[c], j_out[c], 1e-5)
    with tpath.override(tpath.CANDIDATES[port_path]):
        t_d = texpr.evaluate_expressions([tm], {k: torch.from_numpy(v) for k, v in pts.items()},
                                         _derivs(tad, names))
    for n in names:
        close(t_d[n], j_d[n], 1e-5)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(sum((t_d[n] ** 2).mean() for n in names), list(named.values()), allow_unused=True)
    j_g = flatten_tree(jax.tree.map(np.asarray, j_g))
    assert set(j_g) == set(named)
    for (n, p), g in zip(named.items(), grads):
        close(torch.zeros_like(p) if g is None else g, j_g[n], 1e-4)
