"""Helpers of the graph and UNetEx parity tests: a JAX arch against the
port's on inputs that are not a dict of arrays (graph tuples with host
index arrays), the JAX examples' hand loops recorded step by step, and
three solver steps with numpy's global generator reseeded on each side
(topopt's augmentation draws from it)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _earthformer_parity import FAST, fast_call
from _operator_parity import close
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params


def grads_parity(jm, tm, j_call, t_call, rtol=1e-5, seed=11, x64=False):
    """Load ``jm``'s parameters into ``tm``; hold ``t_call(tm)`` (a dict of
    outputs) against ``j_call(jm)`` (the JAX call, its inputs closed over)
    and the parameter gradients of sum(out * c) for a fixed numpy
    cotangent c per output: each output within ``rtol`` of its largest
    magnitude, each gradient within ``rtol`` of the largest magnitude of
    the whole gradient (every parameter). With ``x64`` both sides run in
    float64 (JAX under ``jax.enable_x64(True)``, the port's module cast after the
    load; ``j_call`` and ``t_call`` then feed float64 inputs). Returns the
    port's outputs."""
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    if x64:
        tm.double()
    tout = t_call(tm)
    rng = np.random.default_rng(seed)
    dtype = np.float64 if x64 else np.float32
    cots = {k: rng.standard_normal(tuple(v.shape)).astype(dtype) for k, v in tout.items()}
    with contextlib.ExitStack() as stack:
        if x64:
            stack.enter_context(jax.enable_x64(True))
        params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)), jm.param_tree())
        rest = jm.buffer_tree()

        def out_and_grads(p):
            def fwd(q):
                with jm.bind(q, rest):
                    return j_call(jm)

            out, vjp = jax.vjp(fwd, p)
            return out, vjp({k: jnp.asarray(c) for k, c in cots.items()})[0]

        jout, jgrads = jax.tree.map(np.asarray, fast_call(out_and_grads, params))
    assert set(tout) == set(jout)
    for k in jout:
        close(tout[k], jout[k], rtol)
    jgrads = flatten_tree(jgrads)
    names, ps = zip(*[(n, p) for n, p in tm.named_parameters() if p.requires_grad])
    assert set(names) == set(jgrads), sorted(set(names) ^ set(jgrads))
    loss = sum((v * torch.from_numpy(cots[k])).sum() for k, v in tout.items())
    # each parameter within rtol of the whole gradient's largest magnitude: a parameter whose gradient is 0
    # in exact arithmetic (a bias just before a batch-statistics norm) holds float32 noise on both sides
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for n, g, p in zip(names, torch.autograd.grad(loss, ps, allow_unused=True), ps):
        want = jgrads[n]
        owner, _, leaf = n.rpartition(".")
        if getattr(tm.get_submodule(owner), "jax_layout", {}).get(leaf) == "conv":  # load_jax_params' rule
            want = np.moveaxis(want, (-1, -2), (0, 1))
        got = (g if g is not None else torch.zeros_like(p)).detach().numpy()
        assert got.shape == want.shape, (n, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=n)
    return tout


@contextlib.contextmanager
def recorded_jit(losses, position=2):
    """``jax.jit`` replaced by a wrapper that compiles with :data:`FAST`
    (per static arguments) and appends ``float(out[position])`` of every
    call to ``losses``: the JAX examples' loops jit a step returning
    (params, opt_state, loss) and print only the first and last loss."""
    real = jax.jit

    def jit(fn=None, **kw):
        if fn is None:
            return lambda f: jit(f, **kw)
        jitted = real(fn, **kw)
        static = kw.get("static_argnums", ())
        static = (static,) if isinstance(static, int) else tuple(static)
        compiled = {}

        def call(*args):
            if any(isinstance(a, jax.core.Tracer) for a in jax.tree.leaves(args)):
                return jitted(*args)  # a jit inside a traced function: not a step of the loop
            key = tuple(args[i] for i in static)
            if key not in compiled:
                compiled[key] = jitted.lower(*args).compile(compiler_options=FAST)
            out = compiled[key](*[a for i, a in enumerate(args) if i not in static])
            losses.append(float(out[position]))
            return out

        return call

    jax.jit = jit
    try:
        yield losses
    finally:
        jax.jit = real


_JIT = jax.jit  # the real one, whatever :func:`recorded_jit` has put in its place


def capture_arch(monkeypatch, module, name, captured, jit_apply=False, **overrides):
    """``module.name`` (a JAX arch class) replaced by a constructor that
    applies ``overrides``, builds under ``numpy_init`` (``jit_apply``:
    jits the instance's ``apply``) and keeps the instance and a numpy copy
    of its initial parameters in ``captured``."""
    from _earthformer_parity import numpy_init

    orig = getattr(module, name)

    def build(*a, **kw):
        with numpy_init():
            m = orig(*a, **{**kw, **overrides})
        if jit_apply:  # an example's eager evaluation would compile every op on its own
            m.apply = _JIT(m.apply)
        captured["model"] = m
        captured["params"] = jax.tree.map(np.asarray, m.param_tree())
        return m

    build.coarsen = getattr(orig, "coarsen", None)
    monkeypatch.setattr(module, name, build)


def reseeded_steps(js, ts, seed=0, steps=3, keys=("loss", "lr")):
    """``steps`` train steps of a JAX solver (its step compiled with
    :data:`FAST`, shuffle off) and of the port's from the same parameters
    (shuffle off too), numpy's global generator seeded with ``seed`` before
    each side's steps: the logs within 1e-4. Returns the JAX logs."""
    for c in list(js.constraint.values()) + list(ts.constraint.values()):
        c.data_loader.shuffle = False
        c.data_iter = iter(c.data_loader)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    step_fn, compiled = js._build_train_step(), None
    np.random.seed(seed)
    j_logs = []
    for _ in range(steps):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        if compiled is None:
            compiled = step_fn.lower(js.state, host).compile(compiler_options=FAST)
        js.state, logs = compiled(js.state, host)
        j_logs.append([float(logs[k]) for k in keys])
    np.random.seed(seed)
    t_logs = [[float(v) for k, v in ts.train_step().items() if k in keys] for _ in range(steps)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)
    return j_logs


CUT = dict(hidden=16, n_layers=2)  # the graph examples' networks, cut for the CPU


def run_jax(fn, *args, **kwargs):
    """The JAX example's loop with each step's loss recorded. Its closing
    check that the loss fell over the example's own step count is not
    what these 3 steps test."""
    losses = []
    with recorded_jit(losses):
        try:
            fn(*args, **kwargs)
        except AssertionError:
            pass
    return losses


def port_losses(fit, params, steps=3):
    load_jax_params(fit.model, params)
    return [float(v) for v in fit.train_steps(steps, graphed=False)]
