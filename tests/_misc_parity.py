"""Helpers of the misc-slice example parity tests: the port's parameters
against a JAX param tree after a few steps, three solver steps and the
parameters after them, and the JAX examples' hand loops run with
``jax.jit`` wrapped to compile at XLA's lowest optimisation level and
record every step's outputs."""

import contextlib

import jax
import numpy as np

from _earthformer_parity import FAST, three_steps
from paddlescience_torch.utils.jax_params import flatten_tree


def params_close(jparams, module, rtol=1e-4, free=None):
    """The port module's parameters against a JAX param tree (conv kernels
    transposed): each within ``rtol`` of the largest magnitude of all of
    them. A parameter whose gradient is 0 in exact arithmetic takes Adam
    steps of up to the lr in the direction of float32 noise, on both sides
    (the key half of the Transformer's ``kv_x`` bias: softmax ignores a
    shift common to every key; phi times a constant is 0): ``free`` maps
    such a parameter's name to (entries, bound), and those entries are held
    within ``bound`` (twice the lr times the steps) instead."""
    flat = flatten_tree(jax.tree.map(np.asarray, jparams))
    named = dict(module.named_parameters())
    assert set(flat) == set(named)
    scale = max(float(np.abs(v).max()) for v in flat.values())
    for n, want in flat.items():
        owner, _, leaf = n.rpartition(".")
        if getattr(module.get_submodule(owner), "jax_layout", {}).get(leaf) == "conv":
            want = np.moveaxis(want, (-1, -2), (0, 1))
        got = named[n].detach().numpy().copy()
        if n in (free or {}):
            entries, bound = free[n]
            assert np.abs(got[entries] - want[entries]).max() <= bound, n
            got[entries] = want[entries]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=n)


def solver_steps(js, ts):
    """three_steps, then the parameters."""
    logs = three_steps(js, ts)
    params_close(js.state["params"], ts.model)
    return logs


@contextlib.contextmanager
def recorded(records):
    """``jax.jit`` replaced by one that compiles with FAST and appends the
    numpy outputs of every top-level call returning a tuple (a step) to
    ``records`` as (function name, outputs)."""
    real = jax.jit

    def jit(fn=None, **kw):
        if fn is None:
            return lambda f: jit(f, **kw)
        jitted, compiled = real(fn, **kw), []

        def call(*args):
            if any(isinstance(a, jax.core.Tracer) for a in jax.tree.leaves(args)):
                return jitted(*args)
            if not compiled:
                compiled.append(jitted.lower(*args).compile(compiler_options=FAST))
            out = compiled[0](*args)
            if isinstance(out, tuple):
                records.append((fn.__name__, jax.tree.map(np.asarray, out)))
            return out

        return call

    jax.jit = jit
    try:
        yield records
    finally:
        jax.jit = real


def run_jax(fn, *args, **kwargs):
    """The JAX example's loop, its steps recorded; its closing check that
    the loss fell over its own step count is not what these steps test."""
    records = []
    with recorded(records):
        try:
            fn(*args, **kwargs)
        except AssertionError:
            pass
    return records
