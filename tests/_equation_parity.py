"""Shared by the equation parity tests: the same residuals and parameter
gradients from paddlescience_tpu (sympy forms lowered) and from the port
(closures), through networks with the same weights on the same seeded
points."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.solver.solver import _convert_expr
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch.arch import MLP as TMLP, ModelList as TModelList
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

N, WIDTH, LAYERS = 24, 12, 2
RTOL = 1e-5


def _nets(specs, seed=3):
    """A JAX ModelList of MLPs (inputs, outputs) and the port's copy."""
    jnets = [psci.arch.MLP(i, o, LAYERS, WIDTH, rngs=Rngs(seed + k)) for k, (i, o) in enumerate(specs)]
    tnets = [TMLP(i, o, LAYERS, WIDTH, device="cpu") for i, o in specs]
    jml, tml = psci.arch.ModelList(jnets), TModelList(tnets)
    load_jax_params(tml, jax.tree.map(np.asarray, jml.param_tree()))
    return jml, tml


def _inputs(keys, seed=4, normals=False):
    rng = np.random.default_rng(seed)
    inp = {k: rng.uniform(0.2, 1.0, (N, 1)).astype(np.float32) for k in keys}
    if normals:
        n = rng.standard_normal((N, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        inp.update({f"normal_{a}": n[:, i : i + 1] for i, a in enumerate("xyz")})
    return inp


def run_both(jeq, teq_, specs, keys, normals=False, extra=None, deriv="jet", names=None):
    """(JAX residuals, JAX gradient by parameter name, port residuals,
    port gradient) of ``sum of squared residuals``."""
    jml, tml = _nets(specs)
    inp = _inputs(keys, normals=normals)
    names = names or list(jeq.equations)
    jexprs = _convert_expr({k: jeq.equations[k] for k in names})
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    jextra = {k: jnp.asarray(v) for k, v in (extra or {}).items()}

    def jloss(params, extra_values):
        with jml.bind(params), jpath.override(jpath.CANDIDATES["jet"]):
            res = jexpr.evaluate_expressions(jml.model_list, jin, jexprs, extra_values=extra_values)
        return sum(jnp.sum(res[k] ** 2) for k in names), {k: res[k] for k in names}

    (_, jres), (jgrad, jgrad_eq) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jml.param_tree(), jextra)
    jgrad = {**flatten_tree(jax.tree.map(np.asarray, jgrad)),
             **{f"eq.{k}": np.asarray(v) for k, v in jgrad_eq.items() if k in teq_.learnable_parameters}}
    with tpath.override(tpath.CANDIDATES[deriv]):
        tres = texpr.evaluate_expressions(list(tml.model_list), {k: torch.from_numpy(v) for k, v in inp.items()},
                                          {k: teq_.equations[k] for k in names},
                                          extra_values={k: torch.tensor(v) for k, v in (extra or {}).items()})
    loss = sum((tres[k] ** 2).sum() for k in names)
    params = {**dict(tml.named_parameters()), **{f"eq.{k}": v for k, v in teq_.learnable_parameters.items()}}
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    tgrad = {n: (g if g is not None else torch.zeros_like(p)) for (n, p), g in zip(params.items(), grads)}
    return jres, jgrad, tres, tgrad


def close(got, ref, what, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30), err_msg=what)


def check(jeq, teq_, specs, keys, **kw):
    assert list(teq_.equations) == list(jeq.equations)
    jres, jgrad, tres, tgrad = run_both(jeq, teq_, specs, keys, **kw)
    for k in jres:
        close(tres[k], jres[k], k)
    assert set(jgrad) == set(tgrad)
    for n, g in jgrad.items():
        close(tgrad[n], g, f"d/d {n}")
    return jgrad, tgrad
