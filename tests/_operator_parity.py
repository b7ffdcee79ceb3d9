"""Helpers of the operator parity tests: JAX modules and solvers against
the port's on the CPU, with the same parameters (``load_jax_params``,
conv kernels transposed) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params


@pytest.fixture(autouse=True)
def highest_precision():
    prng = jax.config.values["jax_default_prng_impl"]
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jax.config.update("jax_default_prng_impl", prng)


def close(got, ref, rtol):
    """Within ``rtol`` relative to the largest magnitude of ``ref``."""
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def arch_parity(jm, tm, inputs, seed=11):
    """Forward of a JAX arch and the port's on the same dict of numpy
    inputs (1e-5), then the parameter gradients of sum(out * c) for a
    fixed cotangent c per output (1e-4); the JAX forward and gradient in
    one compilation. Returns the JAX outputs."""
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    params, rest = jm.param_tree(), jm.buffer_tree()

    def fwd(p):
        with jm.bind(p, rest):
            return jm({k: jnp.asarray(v) for k, v in inputs.items()})

    rng = np.random.default_rng(seed)
    cots = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jax.eval_shape(fwd, params).items()}

    def out_and_grads(p):
        out, vjp = jax.vjp(fwd, p)
        return out, vjp({k: jnp.asarray(c) for k, c in cots.items()})[0]

    jout, j_grads = jax.tree.map(np.asarray, jax.jit(out_and_grads)(params))
    j_grads = flatten_tree(j_grads)
    tout = tm({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert set(tout) == set(jout)
    for k in jout:
        close(tout[k], jout[k], 1e-5)
    names, ps = zip(*[(n, p) for n, p in tm.named_parameters() if p.requires_grad])
    t_loss = sum((v * torch.from_numpy(cots[k])).sum() for k, v in tout.items())
    for n, g, p in zip(names, torch.autograd.grad(t_loss, ps, allow_unused=True), ps):
        want = j_grads[n]
        if type(tm.get_submodule(n.rpartition(".")[0])).__name__ == "Conv" and n.endswith("weight"):
            want = np.moveaxis(want, (-1, -2), (0, 1))
        close(g if g is not None else torch.zeros_like(p), want, 1e-4)
    return jout


def three_steps(js, ts, keys=("loss", "lr")):
    """Three train steps of a JAX solver (its jitted step, shuffle off) and
    of the port's from the same parameters: the logs within 1e-4."""
    for c in js.constraint.values():
        if c.data_loader is not None:
            c.data_loader.shuffle = False
            c.data_iter = iter(c.data_loader)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    step_fn = js._build_train_step()
    j_logs = []
    for _ in range(3):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        js.state, logs = step_fn(js.state, host)
        j_logs.append([float(logs[k]) for k in keys])
    t_logs = [[float(v) for k, v in ts.train_step().items() if k in keys] for _ in range(3)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)
