"""The port's LNO slice against paddlescience_tpu on the CPU: ``Laplace`` in
1-D, 2-D and 3-D, the hand-ordered contractions, ``LNO``, the Brusselator
generator against ``tools/gen_brusselator3d.py`` and the brusselator3d_lno
example.

Both packages get the same parameters (``load_jax_params``; the grid
buffers are rebuilt by each) and the same numpy-seeded inputs; JAX runs at
"highest" matmul precision. Tolerances (relative to the largest magnitude
of the JAX value): forwards 1e-5, parameter gradients 1e-4, each
contraction sequence against one ``torch.einsum`` 1e-5; the example's
decoded L2Rel 1e-5 before training, its three train steps 1e-4 (losses)
and 0.1 lr (parameters: AdamW moves a parameter whose gradient is near 0
by up to lr whichever sign its last bits give it), the L2Rel after them
1e-3; the
generator's inputs bitwise, its frames within 5e-4 x max |u| of the tool's
(the two FFT libraries differ by about 3 ulp a step, and over the 9500
steps of the rollout that settles near 2e-4 of max |u|).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import FAST, fast_call, one_torch_thread  # noqa: F401
from paddlescience_tpu.arch import lno as jlno
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import lno as tlno
from paddlescience_torch.data.dataset import brusselator as tbru
from paddlescience_torch.examples import brusselator3d_lno as tex
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import brusselator3d_lno as jex  # noqa: E402  (the JAX example)
import gen_brusselator3d as tool  # noqa: E402  (the JAX data tool)

G = torch.Generator().manual_seed(0)


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def tool_npz(tmp_path_factory):
    """The tool's data set at 2 train and 1 test samples, written by its own
    ``main`` to a file."""
    path = str(tmp_path_factory.mktemp("bru") / "brusselator3d_dataset.npz")
    argv = sys.argv
    sys.argv = ["gen_brusselator3d.py", "--n-train", "2", "--n-test", "1", "--out", path]
    try:
        tool.main()
    finally:
        sys.argv = argv
    return path


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _grids(dims, nt=9, nx=6):
    T = np.linspace(0, 19, nt, dtype=np.float32).reshape(1, nt)
    X = np.linspace(0, 1, nx, dtype=np.float32).reshape(1, nx)
    return T, tuple(X[:, : nx - d] for d in range(dims - 1))


def _forward_and_grads(jm, tm, call_j, call_t, x):
    params, rest = jm.param_tree(), jm.buffer_tree()

    def fwd(p):
        with jm.bind(p, rest):
            return call_j(jm, jnp.asarray(x))

    jout = np.asarray(fast_call(fwd, params))
    cot = np.random.default_rng(11).standard_normal(jout.shape).astype(np.float32)
    j_grads = flatten_tree(jax.tree.map(np.asarray, fast_call(jax.grad(lambda p: jnp.sum(fwd(p) * cot)), params)))
    tout = call_t(tm, torch.from_numpy(x))
    grads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(), list(tm.parameters()))
    _close(tout, jout, 1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(j_grads)
    for n, g in zip(names, grads):
        _close(g, j_grads[n], 1e-4)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_laplace_layer_matches_jax(dims):
    T, data = _grids(dims)
    modes = (4, 3, 2)[:dims]
    jm = jlno.Laplace(3, 3, modes, T, data, rngs=Rngs(dims))
    tm = tlno.Laplace(3, 3, modes, T, data, generator=G)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))  # the grids are rebuilt, not carried
    for k, v in flatten_tree(jax.tree.map(np.asarray, jm.buffer_tree())).items():
        assert np.array_equal(dict(tm.named_buffers())[k].numpy(), v), k
    shape = (2, 3, T.shape[1]) + tuple(d.shape[1] for d in data)
    x = np.random.default_rng(dims).standard_normal(shape).astype(np.float32)
    _forward_and_grads(jm, tm, lambda m, v: m(v), lambda m, v: m(v), x)


def _cplx(rng, shape):
    return torch.complex(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                         torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_each_contraction_sequence_equals_one_einsum(dims):
    """steady_response, transient_residues and transient_response against
    the JAX layer's single einsum (``eq1``, ``eq2``, ``eq_x2``) in torch."""
    rng = np.random.default_rng(20 + dims)
    B, I, O, P, M = 2, 3, 3, (5, 4, 3)[:dims], (3, 2, 2)[:dims]
    jm = jlno.Laplace(I, O, M, *_grids(dims), rngs=Rngs(0))
    alpha, residue = _cplx(rng, (B, I) + P), _cplx(rng, (I, O) + M)
    terms = [_cplx(rng, (P[d], I, O, M[d])) for d in range(dims)]
    exps = [_cplx(rng, (I, O, M[d], P[d])) for d in range(dims)]
    res2 = _cplx(rng, (B, I) + M)
    _close(torch.view_as_real(tlno.steady_response(alpha, residue, terms)),
           torch.view_as_real(torch.einsum(jm.eq1, alpha, residue, *terms)), 1e-5)
    _close(torch.view_as_real(tlno.transient_residues(alpha, residue, terms)),
           torch.view_as_real(torch.einsum(jm.eq2, alpha, residue, *terms)), 1e-5)
    _close(torch.view_as_real(tlno.transient_response(res2, exps)),
           torch.view_as_real(torch.einsum(jm.eq_x2, res2, *exps)), 1e-5)


def _lnos(dims=3, act="relu", use_norm=True, width=4):
    T, data = _grids(dims)
    kw = dict(width=width, modes=(3, 2, 2)[:dims], T=T, data=data, in_features=4, hidden_features=8,
              activation=act, use_norm=use_norm)
    jm = psci.arch.LNO(("input",), ("output",), rngs=Rngs(3), **kw)
    tm = tlno.LNO(("input",), ("output",), device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    shape = (2, T.shape[1]) + tuple(d.shape[1] for d in data) + (4,)
    return jm, tm, np.random.default_rng(dims).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dims,act,use_norm", [(3, "relu", True), (2, "sin", True), (1, "tanh", False)])
def test_lno_forward_and_gradients_match_jax(dims, act, use_norm):
    jm, tm, x = _lnos(dims, act, use_norm)
    _forward_and_grads(jm, tm, lambda m, v: m({"input": v})["output"], lambda m, v: m({"input": v})["output"], x)


def test_lno_checks_its_dims():
    T, (X,) = _grids(2)
    with pytest.raises(ValueError, match="Dims of modes"):
        tlno.LNO(("i",), ("o",), 4, (2, 2, 2), T, (X,), device="cpu")
    with pytest.raises(ValueError, match="Only 3 dims"):
        tlno.LNO(("i",), ("o",), 4, (2, 2, 2, 2), T, (X, X, X), device="cpu")


def test_brusselator_inputs_bitwise_and_frames_match_the_tool(tool_npz):
    data = tbru.load_or_generate(tool_npz)
    assert {k: v.shape for k, v in data.items()} == {
        "inputs_train": (2, 39), "outputs_train": (2, 39, 28, 28), "inputs_test": (1, 39),
        "outputs_test": (1, 39, 28, 28)}
    for part, n, seed in (("train", 2, 7), ("test", 1, 8)):
        inputs = tbru.signals(tbru.forcings(n, seed))
        assert inputs.dtype == data[f"inputs_{part}"].dtype and np.array_equal(inputs, data[f"inputs_{part}"])
    ic = tbru.initial_perturbation()
    assert np.array_equal(ic, 0.1 * np.random.default_rng(1234).standard_normal((28, 28)))
    frames = tbru.simulate(tbru.forcings(2, 7), ic, "cpu").numpy()
    ref = data["outputs_train"]
    assert frames.dtype == np.float32 and np.array_equal(frames[:, 0], ref[:, 0])
    assert np.abs(frames - ref).max() <= 5e-4 * np.abs(ref).max(), np.abs(frames - ref).max()


def test_brusselator_lno_three_train_steps_match_jax(tool_npz, monkeypatch, tmp_path):
    """The example on the tool's 2 + 1 samples (batch 2, shuffle off in
    both): the decoded L2Rel eval, three train steps against the JAX
    solver's jitted step, the eval again."""
    monkeypatch.setattr(jex, "_DATA", tool_npz)
    js = jex.build_solver(epochs=1, iters_per_epoch=3, batch_size=2, output_dir=str(tmp_path / "jax"))
    loader = js.constraint["sup"].data_loader
    loader.shuffle = False
    js.constraint["sup"].data_iter = iter(loader)
    ts = tex.build_solver(epochs=1, iters_per_epoch=3, batch_size=2, output_dir=str(tmp_path / "port"),
                          data_path=tool_npz, shuffle=False, device="cpu")
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    for name in ("input", "output"):
        part = "input" if name == "input" else "label"
        assert np.array_equal(getattr(ts.constraint["sup"].dataset, part)[name],
                              getattr(js.constraint["sup"].dataset, part)[name])
    j_metric, _ = js.eval()
    t_metric, t_group = ts.eval()
    assert set(t_group["sup_valid"]) == {"decoded.L2Rel"}
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-5)
    j_logs, step_fn, compiled = [], js._build_train_step(), None
    for _ in range(3):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        if compiled is None:
            compiled = step_fn.lower(js.state, host).compile(compiler_options=FAST)
        js.state, logs = compiled(js.state, host)
        j_logs.append([float(logs[k]) for k in ("loss", "lr")])
    t_logs = [[float(v) for k, v in ts.train_step().items() if k in ("loss", "lr")] for _ in range(3)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    for n, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=1e-4, atol=0.1 * 5e-3, err_msg=n)
    # after AdamW steps the parameters differ by up to 0.1 lr (near-zero gradients), the metric by < 1e-3
    np.testing.assert_allclose(ts.eval()[0], float(js.eval()[0]), rtol=1e-3)
