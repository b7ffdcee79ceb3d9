"""The fused tanh-MLP jet segment of the PyTorch port (ops/jet_mlp.py)
against the JAX package's Pallas segment (ops/jet_pallas.py), run through
the Pallas interpreter on the CPU as tests/test_jet_pallas.py runs it.

Values and gradients (weights, biases and input streams) of the port's
plain version and of its autograd.Function (hand-derived backward and
weight-gradient sum on the CPU) must match the JAX kernel in both
save-bounds and recompute modes, with a ragged last tile (n=70, JAX tile
32). Tolerance: rtol 1e-4 with an absolute floor of 1e-4 times the
reference's largest magnitude, since the Pallas kernel's split matmuls
order the float32 sums differently (ops/jet_pallas.py:202-205).

The hand-derived backward and the kernels themselves are tested in
tests/test_torch_jet_mlp_kernels.py, which imports no JAX so that it also
runs on the GPU machine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_tpu.arch.mlp import _mlp_segment_fn, _stage_leaf_ranges
from paddlescience_tpu.autodiff import jet as jjet
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.ops import jet_pallas as jp
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.ops import jet_mlp as J

RTOL = 1e-4
INDICES = [[(0,), (1,), (1, 1)], [(0,), (0, 1), (1, 1)]]


@pytest.fixture(autouse=True)
def _interpret_and_float32(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _case(multis, L, n=70, w=24, seed=0):
    rng = np.random.default_rng(seed)
    S = len(jjet.build_index(multis))
    streams = [rng.standard_normal((n, w)).astype(np.float32) for _ in range(S)]
    weights = [(rng.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32) for _ in range(L)]
    biases = [(0.1 * rng.standard_normal((w,))).astype(np.float32) for _ in range(L)]
    cot = [rng.standard_normal((n, w)).astype(np.float32) for _ in range(S)]
    return streams, weights, biases, cot


def _jax_segment(multis, streams, weights, biases, cot, save_bounds):
    """Value and gradients of sum_s <out_s, cot_s> through the Pallas segment."""
    L = len(weights)
    idx = jjet.build_index(multis)

    def layer_stage(i):
        def stage(ws, y_):
            return (jjet.elementwise(jjet.linear(y_, ws[2 * i], ws[2 * i + 1]), jnp.tanh),)
        return stage

    spec = jp.SegmentSpec(
        _mlp_segment_fn((jnp.tanh,) * L, False), idx, n_in=1, n_out=1, block_m=32, interpret=True,
        stages=tuple(layer_stage(i) for i in range(L)),
        stage_ws_idx=_stage_leaf_ranges([(w, b) for w, b in zip(weights, biases)]),
    )
    ws = tuple(jnp.asarray(a) for pair in zip(weights, biases) for a in pair)

    def loss(ws, ss):
        out = jp.fused_jet_segment(spec, ws, jjet.Jet(ss, idx))
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out.streams, cot)), out.streams

    flags = {"PSCI_JET_SAVE_BOUNDS": "1" if save_bounds else "0"}
    with jpath.override(flags):
        (val, outs), (gws, gss) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            ws, [jnp.asarray(s) for s in streams])
    return outs, gss, gws[0::2], gws[1::2]


def _torch_leaves(streams, weights, biases):
    return ([torch.from_numpy(a).requires_grad_() for a in streams],
            [torch.from_numpy(a).requires_grad_() for a in weights],
            [torch.from_numpy(a).requires_grad_() for a in biases])


@pytest.mark.parametrize("save_bounds", [False, True])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("multis", INDICES)
def test_segment_matches_pallas_kernel(multis, L, save_bounds):
    streams, weights, biases, cot = _case(multis, L)
    j_outs, j_gs, j_gw, j_gb = _jax_segment(multis, streams, weights, biases, cot, save_bounds)
    idx = tjet.build_index(multis)

    # plain version: values
    plain_outs, _ = J.jet_mlp_fwd_plain([torch.from_numpy(a) for a in streams],
                                        [torch.from_numpy(a) for a in weights],
                                        [torch.from_numpy(a) for a in biases], idx)
    for a, b in zip(plain_outs, j_outs):
        _close(a, b)

    # autograd.Function: values and every gradient
    ss, ws, bs = _torch_leaves(streams, weights, biases)
    out = J.jet_mlp_segment(tjet.Jet(ss, idx), ws, bs, save_bounds=save_bounds)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out.streams, cot))
    grads = torch.autograd.grad(loss, ss + ws + bs)
    for a, b in zip(out.streams, j_outs):
        _close(a, b)
    for a, b in zip(grads, list(j_gs) + list(j_gw) + list(j_gb)):
        _close(a, b)


def test_index_tables():
    kinds, pa, pb = J.index_tables(tjet.build_index([(0,), (0, 1), (1, 1)]))
    # ((), (0,), (1,), (0, 1), (1, 1))
    assert kinds == [0, 1, 1, 2, 2]
    assert pa[3:] == [1, 2] and pb[3:] == [2, 2]


@pytest.mark.parametrize("multis", INDICES)
def test_refused_width_matches_the_pallas_kernel(multis):
    """cylinder2d's MLP 5x50 under ``jet_pallas_full``: the JAX package runs
    its hidden layers through the Pallas segment (interpreted), which takes
    any width; the port runs them through its segment too, zero-padded to
    width 52, since the Hopper kernels take layer outputs that are
    multiples of 4 only (``ops/jet_mlp.py::pad_widths``). Same parameters,
    same inputs: the jet streams and every parameter gradient agree."""
    import paddlescience_tpu as psci
    from paddlescience_tpu.nn.core import Rngs
    from paddlescience_torch.arch.mlp import MLP as TMLP
    from paddlescience_torch.autodiff import path as tpath
    from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

    np_tree = lambda tree: jax.tree.map(np.asarray, tree)
    jm = psci.arch.MLP(("t", "x", "y"), ("u", "v", "p"), 5, 50, rngs=Rngs(3))
    tm = TMLP(("t", "x", "y"), ("u", "v", "p"), 5, 50, device="cpu")
    load_jax_params(tm, np_tree(jm.param_tree()), np_tree(jm.buffer_tree()))
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.0, 1.0, (40, 3)).astype(np.float32)
    cot = [rng.standard_normal((40, 3)).astype(np.float32) for _ in range(len(multis) + 1)]
    flags = tpath.CANDIDATES["jet_pallas_full"]

    def jloss(params):
        with jm.bind(params):
            out = jm.forward_jet(jjet.seed(jnp.asarray(x), jjet.build_index(multis)))
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out.streams, cot)), out.streams

    with jpath.override(flags):
        (_, j_streams), j_grads = jax.value_and_grad(jloss, has_aux=True)(jm.param_tree())
    assert getattr(jm, "_jet_specs", None), "the JAX model did not take its Pallas segment"
    with tpath.override(flags):
        assert tm.jet_segment_lengths() == [5]
        out = tm.forward_jet(tjet.seed(torch.from_numpy(x), tjet.build_index(multis)))
        names, params = zip(*tm.named_parameters())
        t_grads = dict(zip(names, torch.autograd.grad(
            sum((o * torch.from_numpy(c)).sum() for o, c in zip(out.streams, cot)), params)))
    for a, b in zip(out.streams, j_streams):
        _close(a, b, 1e-5)
    j_grads = flatten_tree(np_tree(j_grads))
    assert set(t_grads) == set(j_grads)
    for name, g in j_grads.items():
        _close(t_grads[name], g)
