"""The port's graph datasets and examples against paddlescience_tpu on the
CPU: ``PEMSDataset``, the mesh and grid graph sets and ``CGCNNDataset``
(bitwise), three tgcn_pems solver steps against the JAX solver's (dropout
off in both: the draws cannot match; losses 1e-4), and three steps of each
hand loop (CFDGCN, GraphCast, CGCNN; AMGNet's in
``test_torch_amgnet_examples.py``) against the JAX example's optax Adam
loop, run through the example itself with ``jax.jit`` wrapped to record
each step's loss (``_graph_parity.py``); losses 1e-4, and GraphCast's
RMSE after them 1e-4. The JAX networks are built from numpy draws; CFDGCN
and GraphCast are cut to hidden 16 and 2 layers (the examples' own data
and graphs)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddlescience_tpu as psci
from _earthformer_parity import fast_call, numpy_init, one_torch_thread, three_steps  # noqa: F401
from _graph_parity import CUT, capture_arch, port_losses, run_jax
from _operator_parity import highest_precision  # noqa: F401
from paddlescience_tpu.data.dataset import domain_dataset as jdd
from paddlescience_torch.data.dataset import domain_dataset as tdd
from paddlescience_torch.examples import cfdgcn as tcfd
from paddlescience_torch.examples import cgcnn_property as tcg
from paddlescience_torch.examples import graphcast as tgc
from paddlescience_torch.examples import tgcn_pems as ttgcn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import cfdgcn as jcfd  # noqa: E402  (the JAX examples)
import cgcnn_property as jcg  # noqa: E402
import graphcast as jgc  # noqa: E402
import tgcn_pems as jtgcn  # noqa: E402

def same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and np.array_equal(x, y)


# --------------------------------------------------------------- datasets --


@pytest.mark.parametrize("split", ["train", "val"])
def test_pems_dataset_matches_jax(split):
    kw = dict(num_nodes=16, num_steps=300, split=split)
    j, t = jdd.PEMSDataset(("x",), ("y",), **kw), tdd.PEMSDataset(("x",), ("y",), **kw)
    same_tree((j.input, j.label, j.mean, j.std), (t.input, t.label, t.mean, t.std))
    same_tree(j[np.arange(5)], t[np.arange(5)])


def test_graph_datasets_match_jax():
    for name, kw in (("MeshAirfoilDataset", {}), ("MeshCylinderDataset", {"num_samples": 3}),
                     ("GridMeshAtmosphericDataset", {"lat": 6, "lon": 12})):
        j = getattr(jdd, name)(("input",), ("label",), **kw)
        t = getattr(tdd, name)(("input",), ("label",), **kw)
        assert len(j) == len(t)
        for i in range(len(j)):
            same_tree(j[i], t[i])
    j, t = jdd.CGCNNDataset(num_samples=5), tdd.CGCNNDataset(num_samples=5)
    same_tree(j.items, t.items)
    same_tree(j[np.array([3])], t[np.array([3])])


# ------------------------------------------------------------- tgcn_pems --


def test_tgcn_pems_three_steps_match_jax(tmp_path):
    kw = dict(epochs=1, num_steps=200, batch_size=16)
    with numpy_init():
        js = jtgcn.build_solver(output_dir=str(tmp_path / "jax"), **kw)
    ts = ttgcn.build_solver(output_dir=None, device="cpu", **kw)
    for m in (js.model, ts.model):
        m.sc1.dropout = m.sc2.dropout = 0.0
    three_steps(js, ts)


# ------------------------------------------------------------ hand loops --


def test_cfdgcn_three_steps_match_jax(monkeypatch):
    got = {}
    capture_arch(monkeypatch, psci.arch, "CFDGCN", got)
    want = run_jax(jcfd.run, 3, **CUT)
    np.testing.assert_allclose(port_losses(tcfd.build(device="cpu", **CUT), got["params"]), want, rtol=1e-4)


def test_graphcast_three_steps_and_rmse_match_jax(monkeypatch):
    got = {}
    capture_arch(monkeypatch, psci.arch, "GraphCastNet", got, jit_apply=True)
    want = run_jax(jgc._fit, 3, **CUT)
    fit = tgc.build(device="cpu", **CUT)
    np.testing.assert_allclose(port_losses(fit, got["params"]), want, rtol=1e-4)
    jm = got["model"]  # its parameters after the JAX loop (``_fit`` loads them back)
    x = jnp.stack([jnp.asarray(inp["grid"].numpy()) for inp, _ in fit.samples])
    y = jnp.stack([jnp.asarray(lab.numpy()) for _, lab in fit.samples])
    per_sample = jax.vmap(lambda p, a, b: jnp.sqrt(jnp.mean((jm.apply(p, {"grid": a})["pred"] - b) ** 2)),
                          in_axes=(None, 0, 0))
    want_rmse = float(np.mean(fast_call(per_sample, jm.param_tree(), x, y)))
    np.testing.assert_allclose(tgc.rmse(fit), want_rmse, rtol=1e-4)


def test_cgcnn_three_steps_match_jax(monkeypatch):
    got = {}
    capture_arch(monkeypatch, psci.arch, "CrystalGraphConvNet", got)
    want = run_jax(jcg.main, 3)
    np.testing.assert_allclose(port_losses(tcg.build(device="cpu"), got["params"]), want, rtol=1e-4)
