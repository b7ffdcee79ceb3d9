"""The port's graph networks against paddlescience_tpu on the CPU: the
fixed-order segment sum and gather (``nn/segment.py``) against
``jax.ops.segment_sum`` and ``index_add_`` (repeated receivers, segments
with no edges, gradients), TGCN's batch-statistics norm (population
variance), the host graph construction (``AMGNet.coarsen``,
``build_multimesh``, GraphCast's wiring: equal integer arrays), and each
of the six archs (TGCN, MeshGraphNet, AMGNet, CFDGCN, GraphCastNet with
its flat fallback, CrystalGraphConvNet): outputs and parameter gradients
within 1e-5 of their largest magnitude, hidden 16, 2 layers, 32-node
graphs. JAX modules are built from numpy draws and their functions
compiled at XLA's lowest optimisation level (``_earthformer_parity.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import numpy_init, one_torch_thread  # noqa: F401
from _graph_parity import grads_parity
from _operator_parity import close, highest_precision  # noqa: F401
from paddlescience_tpu.arch import graph_nets as jg
from paddlescience_tpu.data.dataset.domain_dataset import make_synthetic_graph
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import graph_nets as tg
from paddlescience_torch.nn import segment as seg

T = torch.from_numpy
H, L, N = 16, 2, 32  # hidden width, message-passing layers, nodes


def graph(node_dim=5, edge_dim=3, seed=0):
    return make_synthetic_graph(np.random.default_rng(seed), N, 4, node_dim, edge_dim, 3)


# ---------------------------------------------------------- segment sums --


def test_segment_sum_repeated_receivers_and_empty_segments_match_jax():
    rng = np.random.default_rng(0)
    index = np.array([3, 0, 3, 3, 5, 0, 3, 1, 5, 3], np.int32)  # segments 2, 4 and 6 receive nothing
    data = rng.standard_normal((len(index), 4, 2)).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(index), num_segments=7))
    got = seg.segment_sum(T(data), index, 7)
    close(got, want, 1e-6)
    assert not got[[2, 4, 6]].any()
    close(got, seg.segment_sum_plain(T(data), T(index).long(), 7), 1e-6)
    # the backward of each is the gather of the other direction, and the reverse
    x = T(rng.standard_normal((7, 3)).astype(np.float32)).requires_grad_(True)
    cot = rng.standard_normal((len(index), 3)).astype(np.float32)
    (g_x,) = torch.autograd.grad((seg.gather(x, index) * T(cot)).sum(), x)
    close(g_x, np.asarray(jax.ops.segment_sum(jnp.asarray(cot), jnp.asarray(index), num_segments=7)), 1e-6)
    d = T(data).requires_grad_(True)
    c7 = rng.standard_normal((7, 4, 2)).astype(np.float32)
    (g_d,) = torch.autograd.grad((seg.segment_sum(d, index, 7) * T(c7)).sum(), d)
    close(g_d, c7[index], 0.0)


def test_segments_are_cached_per_index_and_check_their_range():
    a = seg.segments(np.array([1, 0, 1]), 3)
    assert seg.segments(np.array([1, 0, 1], np.int32), 3) is a
    assert seg.segments(a, 3) is a
    assert a.order.tolist() == [1, 0, 2] and a.offsets.tolist() == [0, 1, 3] and a.counts.tolist() == [1, 2, 0]
    with pytest.raises(ValueError):
        seg.segments(np.array([0, 4]), 3)
    with pytest.raises(ValueError):
        seg.segments(a, 4)


# --------------------------------------------------------------- TGCN parts --


def test_batch_stat_norm_uses_the_population_variance():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32) * 3 + 1  # 24 values a channel: n / (n - 1) = 1.04
    scale, shift = rng.uniform(0.5, 2, 5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    jn = jg._BatchStatNorm(5, rngs=None)
    want = np.asarray(jn.apply({"scale": jnp.asarray(scale), "shift": jnp.asarray(shift)}, jnp.asarray(x)))
    tn = tg._BatchStatNorm(5)
    with torch.no_grad():
        tn.scale.copy_(T(scale))
        tn.shift.copy_(T(shift))
    got = tn(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # the port is channel-first
    close(got, want, 1e-6)
    unbiased = (T(x) - T(x).mean((0, 1, 2))) / torch.sqrt(T(x).var((0, 1, 2)) + 1e-5) * T(scale) + T(shift)
    assert float((unbiased - torch.tensor(want)).abs().max()) > 1e-3  # the check tells the two variances apart


def test_gru_cell_matches_jax():
    with numpy_init():
        jm = jg._GRUCell(3, H, rngs=Rngs(0))
    rng = np.random.default_rng(2)
    x, h = rng.standard_normal((N, 3)).astype(np.float32), rng.standard_normal((N, H)).astype(np.float32)
    grads_parity(jm, tg._GRUCell(3, H, generator=torch.Generator()), lambda m: {"h": m(jnp.asarray(x), jnp.asarray(h))},
                 lambda m: {"h": m(T(x), T(h))})


def ring(n):
    adj = np.zeros((n, n), np.float32)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1.0
    return adj


def test_tgcn_matches_jax():
    kw = dict(in_dim=1, emb_dim=8, hidden=H, gc_layer=L, tc_layer=L, k_s=3, dropout=0.25, alpha=0.1, input_len=6,
              label_len=4)
    with numpy_init():
        jm = psci.arch.TGCN(("x",), ("y",), adj=ring(8), **kw)
    tm = tg.TGCN(("x",), ("y",), adj=ring(8), **kw)
    x = np.random.default_rng(3).standard_normal((3, 6, 8, 1)).astype(np.float32)
    out = grads_parity(jm, tm, lambda m: m({"x": jnp.asarray(x)}), lambda m: m({"x": T(x)}))
    assert out["y"].shape == (3, 4, 8, 1)


def test_tgcn_dropout_draws_from_the_installed_generator():
    tm = tg.TGCN(("x",), ("y",), adj=ring(8), emb_dim=8, hidden=H, input_len=6, label_len=4)
    x = {"x": torch.randn(2, 6, 8, 1, generator=torch.Generator().manual_seed(0))}
    with torch.no_grad():
        outs = []
        for g in (1, 1, 2, None, None):
            tm.set_train_rng(None if g is None else torch.Generator().manual_seed(g))
            outs.append(tm(x)["y"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[1], outs[2])
    assert torch.equal(outs[3], outs[4]) and not torch.equal(outs[2], outs[3])


# --------------------------------------------------------- host graphs --


def test_coarsen_matches_jax():
    for seed in range(3):
        _, _, s, r, _ = graph(seed=seed)
        want = jg.AMGNet.coarsen(s, r, N)
        got = tg.AMGNet.coarsen(s, r, N)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_build_multimesh_matches_jax(level):
    for a, b in zip(tg.build_multimesh(level), jg.build_multimesh(level)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_graphcast_wiring_matches_jax():
    with numpy_init():
        jm = psci.arch.GraphCastNet(("g",), ("p",), node_in_dim=8, hidden=H, n_layers=L, lat=8, lon=16, mesh_level=2)
    w = tg.graphcast_wiring(8, 16, 2)
    for part in ("g2m", "mesh", "m2g"):
        s, r, ef = (np.asarray(a) for a in getattr(jm, "_" + part))
        assert np.array_equal(w[part + "_s"], s) and np.array_equal(w[part + "_r"], r)
        assert np.array_equal(w[part + "_e"], ef)
    assert np.array_equal(w["mesh_pos"], np.asarray(jm._mesh_feat))
    # the pole rows: all 16 longitudes meet one mesh vertex
    assert len(set(w["g2m_r"][:16])) == 1 and len(set(w["g2m_r"][-16:])) == 1


# ----------------------------------------------------------------- archs --


def test_mesh_graph_net_matches_jax():
    nf, ef, s, r, _ = graph()
    with numpy_init():
        jm = psci.arch.MeshGraphNet(("g",), ("o",), 5, 3, 3, hidden=H, n_layers=L)
    tm = tg.MeshGraphNet(("g",), ("o",), 5, 3, 3, hidden=H, n_layers=L)
    grads_parity(jm, tm, lambda m: m({"g": (jnp.asarray(nf), jnp.asarray(ef), jnp.asarray(s), jnp.asarray(r))}),
                 lambda m: m({"g": (T(nf), T(ef), s, r)}))


def test_amgnet_matches_jax():
    nf, ef, s, r, _ = graph(node_dim=4, seed=1)
    assign, cs, cr = jg.AMGNet.coarsen(s, r, N)
    with numpy_init():
        jm = psci.arch.AMGNet(("g",), ("o",), 4, 3, 3, hidden=H, n_layers=L)
    tm = tg.AMGNet(("g",), ("o",), 4, 3, 3, hidden=H, n_layers=L)
    grads_parity(jm, tm, lambda m: m({"g": (jnp.asarray(nf), jnp.asarray(ef), jnp.asarray(s), jnp.asarray(r),
                                            assign, jnp.asarray(cs), jnp.asarray(cr))}),
                 lambda m: m({"g": (T(nf), T(ef), s, r, assign, cs, cr)}))


def test_cfdgcn_matches_jax():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    import cfdgcn as jcfd

    from paddlescience_torch.examples import cfdgcn as tcfd

    nf, ef, s, r, _ = graph()
    with numpy_init():
        jm = psci.arch.CFDGCN(("g",), ("o",), 8, 3, 3, hidden=H, n_layers=L, cfd_solver=jcfd.potential_flow_surrogate)
    tm = tg.CFDGCN(("g",), ("o",), 8, 3, 3, hidden=H, n_layers=L, cfd_solver=tcfd.potential_flow_surrogate)
    grads_parity(jm, tm, lambda m: m({"g": (jnp.asarray(nf), jnp.asarray(ef), jnp.asarray(s), jnp.asarray(r))}),
                 lambda m: m({"g": (T(nf), T(ef), s, r)}))


def test_graphcast_matches_jax():
    kw = dict(node_in_dim=8, out_dim=8, hidden=H, n_layers=L, lat=4, lon=8, mesh_level=1)
    with numpy_init():
        jm = psci.arch.GraphCastNet(("g",), ("p",), **kw)
    tm = tg.GraphCastNet(("g",), ("p",), **kw)
    x = np.random.default_rng(4).standard_normal((32, 8)).astype(np.float32)
    out = grads_parity(jm, tm, lambda m: m({"g": jnp.asarray(x)}), lambda m: m({"g": T(x)}))
    assert out["p"].shape == (32, 8)


def test_graphcast_flat_fallback_matches_jax():
    nf, ef, s, r, _ = graph(node_dim=8, edge_dim=4)
    with numpy_init():
        jm = psci.arch.GraphCastNet(("g",), ("p",), node_in_dim=8, hidden=H, n_layers=L)
    tm = tg.GraphCastNet(("g",), ("p",), node_in_dim=8, hidden=H, n_layers=L)
    assert not tm.multimesh
    grads_parity(jm, tm, lambda m: m({"g": (jnp.asarray(nf), jnp.asarray(ef), jnp.asarray(s), jnp.asarray(r))}),
                 lambda m: m({"g": (T(nf), T(ef), s, r)}))


def test_cgcnn_matches_jax():
    """In float64 on both sides: this network's output (largest magnitude
    0.08) is a small difference of O(1) activations, so float32 rounding
    reaches 1e-5 of it on either side (against a float64 pass: JAX 2.4e-6,
    the port 1.1e-5), and 1e-5 would test the rounding, not the port.
    CGCNN's float32 path is held by the example's three steps."""
    rng = np.random.default_rng(5)
    sizes = (12, 9, 11)  # three crystals, 32 atoms
    n, m = sum(sizes), 4
    atom = rng.integers(0, 2, (n, 6)).astype(np.float32)
    nbr = rng.standard_normal((n, m, 5)).astype(np.float32)
    offsets = np.cumsum((0,) + sizes[:-1])
    idx = np.concatenate([o + rng.integers(0, k, (k, m)) for o, k in zip(offsets, sizes)]).astype(np.int32)
    crystals = [np.arange(o, o + k) for o, k in zip(offsets, sizes)]
    with numpy_init():
        jm = psci.arch.CrystalGraphConvNet(6, 5, atom_fea_len=H, n_conv=L, h_fea_len=H, n_h=2)
    tm = tg.CrystalGraphConvNet(6, 5, atom_fea_len=H, n_conv=L, h_fea_len=H, n_h=2)
    atom, nbr = atom.astype(np.float64), nbr.astype(np.float64)
    out = grads_parity(jm, tm, lambda mm: mm({"i": (jnp.asarray(atom), jnp.asarray(nbr), jnp.asarray(idx),
                                                    [jnp.asarray(c) for c in crystals])}),
                       lambda mm: mm({"i": (T(atom), T(nbr), idx, crystals)}), x64=True)
    assert out["out"].shape == (3, 1)
