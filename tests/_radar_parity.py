"""Helpers of the DGMR, NowcastNet, MoFlow and radar-example parity tests:
a JAX module against the port's on the same parameters, with the forward
and the gradient held to tolerances of their own, and JAX functions
compiled once per shape at XLA's lowest optimisation level."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _earthformer_parity import FAST
from _operator_parity import close
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

_JIT = jax.jit  # the real one, whatever a recording context puts in its place


def cached_fast(fn):
    """``fn`` jitted and compiled with :data:`FAST` once per argument
    shapes and dtypes (called inside a trace: the plain jitted ``fn``)."""
    jitted, compiled = _JIT(fn), {}

    def call(*args):
        if any(isinstance(a, jax.core.Tracer) for a in jax.tree.leaves(args)):
            return jitted(*args)
        key = tuple((a.shape, a.dtype) for a in jax.tree.leaves(args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=FAST)
        return compiled[key](*args)

    return call


def parity(jm, tm, j_call, t_call, out_rtol=1e-5, grad_rtol=1e-4, seed=11, load=True, x64=False):
    """Load ``jm``'s parameters and buffers into ``tm`` (with ``load``);
    hold ``t_call(tm)`` (a dict of outputs) against ``j_call(jm)`` (the
    JAX call, its inputs closed over), each output within ``out_rtol`` of
    its largest magnitude, and the parameter gradients of sum(out * c) for
    a fixed numpy cotangent c per output, each within ``grad_rtol`` of the
    largest magnitude of the whole gradient. With ``x64`` both sides run
    in float64 (JAX under ``jax.enable_x64``, the port's module cast after
    the load; the calls then feed float64 inputs). Returns the port's
    outputs."""
    if load:
        load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    dtype = np.float64 if x64 else np.float32
    if x64:
        tm.double()
    tout = t_call(tm)
    rng = np.random.default_rng(seed)
    cots = {k: rng.standard_normal(tuple(v.shape)).astype(dtype) for k, v in tout.items()}
    with jax.enable_x64(True) if x64 else contextlib.nullcontext():
        cast = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
        params, rest = jax.tree.map(cast, jm.param_tree()), jax.tree.map(cast, jm.buffer_tree())

        def out_and_grads(p):
            def fwd(q):
                with jm.bind(q, rest):
                    return j_call(jm)

            out, vjp = jax.vjp(fwd, p)
            return out, vjp({k: jnp.asarray(c) for k, c in cots.items()})[0]

        jout, jgrads = jax.tree.map(np.asarray, jax.jit(out_and_grads).lower(params).compile(
            compiler_options=FAST)(params))
    assert set(tout) == set(jout)
    for k in jout:
        close(tout[k], jout[k], out_rtol)
    jgrads = flatten_tree(jgrads)
    names, ps = zip(*[(n, p) for n, p in tm.named_parameters() if p.requires_grad])
    assert set(names) == set(jgrads), sorted(set(names) ^ set(jgrads))
    loss = sum((v * torch.from_numpy(cots[k])).sum() for k, v in tout.items())
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for n, g, p in zip(names, torch.autograd.grad(loss, ps, allow_unused=True), ps):
        want = jgrads[n]
        owner, _, leaf = n.rpartition(".")
        if getattr(tm.get_submodule(owner), "jax_layout", {}).get(leaf) == "conv":
            want = np.moveaxis(want, (-1, -2), (0, 1))
        got = (g if g is not None else torch.zeros_like(p)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=grad_rtol, atol=grad_rtol * scale, err_msg=n)
    return tout


def capture_fast(monkeypatch, module, name, captured):
    """``module.name`` (a JAX module class) replaced by a constructor that
    builds under ``numpy_init``, keeps the instance and numpy copies of
    its initial parameters and buffers in ``captured``, and runs its
    ``apply`` and its calls compiled with :data:`FAST` (a call reads the
    stored parameters), the outputs of each call outside a trace appended
    to ``captured["calls"]`` and of each such ``apply`` to
    ``captured["applies"]``."""
    from _earthformer_parity import numpy_init

    orig = getattr(module, name)
    calls, applies = captured.setdefault("calls", []), captured.setdefault("applies", [])

    def bound(self, params, buffers, *args):
        with self.bind(params, buffers):
            return orig.__call__(self, *args)

    def call(self, *args):
        if any(isinstance(a, jax.core.Tracer) for a in jax.tree.leaves(args)):
            return orig.__call__(self, *args)
        fn = captured.setdefault("fast_call", cached_fast(lambda p, b, *a: bound(self, p, b, *a)))
        out = fn(self.param_tree(), self.buffer_tree(), *args)
        calls.append(jax.tree.map(np.asarray, out))
        return out

    sub = type(name, (orig,), {"__call__": call})

    def build(*a, **kw):
        with numpy_init():
            m = sub(*a, **kw)
        fast_apply = cached_fast(m.apply)

        def apply(*args):
            out = fast_apply(*args)
            if not any(isinstance(a, jax.core.Tracer) for a in jax.tree.leaves(args)):
                applies.append(jax.tree.map(np.asarray, out))
            return out

        m.apply = apply
        captured.update(model=m, params=jax.tree.map(np.asarray, m.param_tree()),
                        buffers=jax.tree.map(np.asarray, m.buffer_tree()))
        return m

    monkeypatch.setattr(module, name, build)


def _port_layout(module, tree):
    """A JAX parameter tree as {dotted name: numpy array} in the port's
    layout (conv kernels moved from (*window, in, out) to (out, in,
    *window))."""
    out = {}
    for n, v in flatten_tree(jax.tree.map(np.asarray, tree)).items():
        owner, _, leaf = n.rpartition(".")
        conv = getattr(module.get_submodule(owner), "jax_layout", {}).get(leaf) == "conv"
        out[n] = np.moveaxis(v, (-1, -2), (0, 1)) if conv else v
    return out


def x64_steps(js, ts, steps=3, keys=("loss", "lr"), rtol=1e-4, param_rtol=1e-6):
    """``steps`` train steps of a JAX solver (its step compiled with
    :data:`FAST` under ``jax.enable_x64``, shuffle off) and of the port's
    (shuffle off), both in float64 from the same parameters: the JAX
    solver's state cast up, the port's model cast after its parameters
    are loaded, its Adam state made anew in float64 and its float32
    batches cast at the model's input. Held after every step: the logs
    within ``rtol``; the Adam moments, each within ``rtol`` of that
    moment's largest magnitude over all parameters, and the parameters
    within ``param_rtol`` of theirs (with parameters of order 1 and a
    learning rate of 1e-3, a thousandth of one Adam step). A
    parameter the loss does not reach has no gradient in the port, and
    torch's Adam leaves it and its state alone: JAX's moments of it must
    be 0 and the parameter unmoved on both sides. Float64 keeps Adam's
    first steps, which move an entry by the learning rate in its
    gradient's sign, from taking float32 rounding's sign. Returns the JAX
    logs."""
    for c in list(js.constraint.values()) + list(ts.constraint.values()):
        c.data_loader.shuffle = False
        c.data_iter = iter(c.data_loader)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    ts.model.double()
    forward = ts.model.forward
    ts.model.forward = lambda feed: forward({k: v.double() for k, v in feed.items()})
    torch_opt = ts.optimizer.torch_opt
    named = dict(ts.model.named_parameters())
    for p in named.values():
        ts.optimizer._init_state(p)
    step_fn, compiled = js._build_train_step(), None
    up = lambda a: a.astype(np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating) else a  # noqa: E731
    j_logs, t_logs = [], []
    with jax.enable_x64(True):
        js.state = jax.tree.map(lambda a: jnp.asarray(up(np.asarray(a))), js.state)
        for _ in range(steps):
            pre = _port_layout(ts.model, js.state["params"])
            host = {n: jax.tree.map(lambda a: jnp.asarray(up(np.asarray(a))), next(c.data_iter))
                    for n, c in js.constraint.items()}
            if compiled is None:
                compiled = step_fn.lower(js.state, host).compile()
            js.state, logs = compiled(js.state, host)
            j_logs.append([float(logs[k]) for k in keys])
            t_logs.append([float(v) for k, v in ts.train_step().items() if k in keys])
            adam = js.state["opt_state"][0]  # over (model parameters, equation parameters)
            trees = [_port_layout(ts.model, t) for t in (adam.mu[0], adam.nu[0], js.state["params"])]
            stepped = {n: p for n, p in named.items() if p.grad is not None}
            for n in set(named) - set(stepped):
                assert not trees[0][n].any() and not trees[1][n].any(), n
                for got in (trees[2][n], named[n].detach().numpy()):
                    np.testing.assert_array_equal(got, pre[n], err_msg=n)
            assert all(int(torch_opt.state[p]["step"]) == int(adam.count) for p in stepped.values())
            for label, want in zip(("exp_avg", "exp_avg_sq", "parameters"), trees):
                scale = max(float(np.abs(v).max()) for v in want.values())
                tol = param_rtol if label == "parameters" else rtol
                for n, p in stepped.items():
                    got = p if label == "parameters" else torch_opt.state[p][label]
                    np.testing.assert_allclose(got.detach().numpy(), want[n], rtol=tol, atol=tol * scale,
                                               err_msg=f"{label}: {n}")
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=rtol)
    return j_logs
