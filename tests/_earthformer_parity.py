"""Helpers of the Earthformer and Koopman parity tests: JAX functions
compiled once at XLA's lowest backend optimisation level (their compile,
not their run, dominates these small shapes; the numbers do not depend on
it beyond float32 rounding), and three train steps of a JAX solver
against the port's."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch at one thread while a file runs: the port's small models run
    thousands of small ops, which the runner's parallel workers, each at
    torch's default thread count, slow down many times over; the
    arithmetic is the same."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def fast_call(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST`."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def arch_grads(jm, inputs, cots):
    """A JAX arch's outputs on ``inputs`` and the parameter gradient of
    sum(out * cots), numpy trees."""
    params, rest = jm.param_tree(), jm.buffer_tree()

    def out_and_grads(p):
        def fwd(q):
            with jm.bind(q, rest):
                return jm({k: jnp.asarray(v) for k, v in inputs.items()})

        out, vjp = jax.vjp(fwd, p)
        return out, vjp({k: jnp.asarray(c) for k, c in cots.items()})[0]

    return jax.tree.map(np.asarray, fast_call(out_and_grads, params))


def three_steps(js, ts, keys=("loss", "lr"), steps=3):
    """``steps`` train steps of a JAX solver (its step compiled with
    :data:`FAST`, shuffle off) and of the port's from the same parameters
    (the port's loaders unshuffled too): the logs within 1e-4."""
    for c in list(js.constraint.values()) + list(ts.constraint.values()):
        c.data_loader.shuffle = False
        c.data_iter = iter(c.data_loader)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    step_fn, compiled = js._build_train_step(), None
    j_logs = []
    for _ in range(steps):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        if compiled is None:
            compiled = step_fn.lower(js.state, host).compile(compiler_options=FAST)
        js.state, logs = compiled(js.state, host)
        j_logs.append([float(logs[k]) for k in keys])
    t_logs = [[float(v) for k, v in ts.train_step().items() if k in keys] for _ in range(steps)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)
    return j_logs


@contextlib.contextmanager
def numpy_init(seed=0):
    """JAX modules built with numpy draws in place of ``jax.random``'s
    uniform, normal and truncated normal (each new shape of which XLA
    compiles): the port loads whatever parameters JAX holds, so their
    values need only be random. Use it around construction only."""
    rng = np.random.default_rng(seed)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    def truncated_normal(key, lower, upper, shape=(), dtype=jnp.float32):
        return jnp.asarray(np.clip(rng.standard_normal(shape), lower, upper), dtype)

    saved = {n: getattr(jax.random, n) for n in ("uniform", "normal", "truncated_normal", "fold_in")}
    jax.random.uniform, jax.random.normal, jax.random.truncated_normal = uniform, normal, truncated_normal
    jax.random.fold_in = lambda key, data: key
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(jax.random, n, f)


def check_arch(jm, tm, inputs, seed=11):
    """``_operator_parity.arch_parity`` with the JAX side compiled with
    :data:`FAST`: the port's forward against JAX's on the same numpy
    inputs (1e-5 of the largest magnitude) and the parameter gradients of
    sum(out * c) for a fixed cotangent c per output (1e-4). The port
    module must hold JAX's parameters already."""
    from _operator_parity import close

    rng = np.random.default_rng(seed)
    tout = tm({k: torch.from_numpy(v) for k, v in inputs.items()})
    cots = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) for k, v in tout.items()}
    jout, jgrads = arch_grads(jm, inputs, cots)
    assert set(tout) == set(jout)
    for k in jout:
        close(tout[k], jout[k], 1e-5)
    jgrads = flatten_tree(jgrads)
    names, ps = zip(*[(n, p) for n, p in tm.named_parameters() if p.requires_grad])
    loss = sum((v * torch.from_numpy(cots[k])).sum() for k, v in tout.items())
    for n, g, p in zip(names, torch.autograd.grad(loss, ps, allow_unused=True), ps):
        want = jgrads[n]
        if n.endswith("weight") and type(tm.get_submodule(n.rpartition(".")[0])).__name__ == "Conv":
            want = np.moveaxis(want, (-1, -2), (0, 1))
        close(g if g is not None else torch.zeros_like(p), want, 1e-4)
