"""Parity of the PyTorch port's jet primitives, embeddings and MLP forwards
with paddlescience_tpu, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages;
parameters are carried from the JAX model with ``load_jax_params``. JAX
matmuls are pinned to "highest" and TF32 is off on the torch side, so both
compute in float32; the tolerance, rtol 1e-5 with an absolute floor of
1e-5 times the reference's largest magnitude, covers summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_tpu.arch import mlp as jmlp
from paddlescience_tpu.autodiff import jet as jjet
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.utils import initializer as jinit
from paddlescience_torch.arch import mlp as tmlp
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.utils import initializer as tinit
from paddlescience_torch.utils.jax_params import load_jax_params

RTOL = 1e-5
MULTIS = [[(0,), (1,), (1, 1)], [(0,), (0, 1), (1, 1)], [(1,)], [(0, 0), (1, 1)]]


@pytest.fixture(autouse=True)
def _float32_everywhere():
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _close_jets(tj, jj, rtol=RTOL):
    assert tj.index.multis == jj.index.multis
    for a, b in zip(tj.streams, jj.streams):
        _close(a, b, rtol)


def _jets(multis, n=40, w=6, seed=0):
    rng = np.random.default_rng(seed)
    jidx, tidx = jjet.build_index(multis), tjet.build_index(multis)
    arrs = [rng.standard_normal((n, w)).astype(np.float32) for _ in range(len(jidx))]
    return (tjet.Jet([torch.from_numpy(a) for a in arrs], tidx),
            jjet.Jet([jnp.asarray(a) for a in arrs], jidx))


@pytest.mark.parametrize("multis", MULTIS)
def test_build_index_and_seed(multis):
    jidx, tidx = jjet.build_index(multis), tjet.build_index(multis)
    assert tidx.multis == jidx.multis
    assert tidx.singles == jidx.singles and tidx.pairs == jidx.pairs
    x = np.random.default_rng(1).standard_normal((12, 2)).astype(np.float32)
    _close_jets(tjet.seed(torch.from_numpy(x), tidx), jjet.seed(jnp.asarray(x), jidx))


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    tj, jj = _jets(MULTIS[0])
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32) if bias else None
    _close_jets(tjet.linear(tj, torch.from_numpy(w), None if b is None else torch.from_numpy(b)),
                jjet.linear(jj, jnp.asarray(w), None if b is None else jnp.asarray(b)))


@pytest.mark.parametrize("name", ["tanh", "sin", "cos", "exp"])
@pytest.mark.parametrize("multis", MULTIS[:2])
def test_elementwise_closed_form_rules(name, multis):
    tj, jj = _jets(multis)
    _close_jets(tjet.elementwise(tj, getattr(torch, name)), jjet.elementwise(jj, getattr(jnp, name)))


def test_elementwise_without_a_rule_raises():
    """The port keeps only the closed-form rules; a function without one is
    refused rather than differentiated some other way."""
    tj, _ = _jets(MULTIS[1])
    with pytest.raises(ValueError, match="no closed-form jet rule"):
        tjet.elementwise(tj, torch.sigmoid)


def test_mul_add_sub_scale_concat_split():
    ta, ja = _jets(MULTIS[0], seed=3)
    tb, jb = _jets(MULTIS[0], seed=4)
    _close_jets(tjet.mul(ta, tb), jjet.mul(ja, jb))
    _close_jets(tjet.add(ta, tb), jjet.add(ja, jb))
    _close_jets(tjet.sub(ta, tb), jjet.sub(ja, jb))
    _close_jets(tjet.scale_const(ta, 0.37), jjet.scale_const(ja, 0.37))
    _close_jets(tjet.concat([ta, tb]), jjet.concat([ja, jb]))
    for tp, jp in zip(tjet.split(ta, [2, 4]), jjet.split(ja, [2, 4])):
        _close_jets(tp, jp)


@pytest.mark.parametrize("name", ["glorot_normal_", "xavier_uniform_"])
def test_initializers_draw_the_jax_distribution(name):
    """The two packages draw different numbers; the distributions must
    agree: same bounds, standard deviations within 2% on 65536 draws."""
    shape = (256, 256)
    if name == "glorot_normal_":
        j = np.asarray(jinit.glorot_normal_(jax.random.PRNGKey(0), shape))
    else:
        j = np.asarray(jinit.xavier_uniform_()(jax.random.PRNGKey(0), shape))
    t = getattr(tinit, name)(torch.empty(shape), torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(t.std(), j.std(), rtol=2e-2)
    np.testing.assert_allclose(np.abs(t).max(), np.abs(j).max(), rtol=2e-2)
    assert abs(t.mean()) < 3 * j.std() / 256


def _models(num_layers=2, width=32, fourier_dim=32, seed=7, rwf=True, outputs=("u",)):
    cfg = dict(activation="tanh", periods={"x": (2.0, False)}, fourier={"dim": fourier_dim, "scale": 1.0},
               random_weight={"mean": 0.5, "std": 0.1} if rwf else None)
    jm = jmlp.MLP(("t", "x"), outputs, num_layers, width, rngs=Rngs(seed), **cfg)
    tm = tmlp.MLP(("t", "x"), outputs, num_layers, width, device="cpu", **cfg)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    return tm, jm


def _coords(n=50, seed=5):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32)
    return t, x


def test_load_jax_params_covers_every_leaf():
    tm, jm = _models()
    names = dict(tm.named_parameters())
    assert set(names) == {
        "fourier_emb.kernel", "last_fc.weight_g", "last_fc.weight_v", "last_fc.bias",
        *(f"linears.{i}.{k}" for i in range(2) for k in ("weight_g", "weight_v", "bias")),
    }
    np.testing.assert_array_equal(names["linears.1.weight_v"].detach().numpy(),
                                  np.asarray(jm.param_tree()["linears"]["1"]["weight_v"]))
    assert float(tm.period_emb.freq_x) == float(jm.buffer_tree()["period_emb"]["freq_x"])


@pytest.mark.parametrize("rwf,outputs", [(True, ("u",)), (False, ("u",)), (True, ("u", "v"))],
                         ids=["rwf", "plain_linear", "two_outputs"])
def test_mlp_forward(rwf, outputs):
    tm, jm = _models(rwf=rwf, outputs=outputs)
    t, x = _coords()
    tout = tm({"t": torch.from_numpy(t), "x": torch.from_numpy(x)})
    jout = jm({"t": jnp.asarray(t), "x": jnp.asarray(x)})
    assert set(tout) == set(jout) == set(outputs)
    for k in outputs:
        _close(tout[k], jout[k])


@pytest.mark.parametrize("multis", MULTIS[:2])
def test_jet_embed(multis):
    tm, jm = _models()
    t, x = _coords()
    xy = np.concatenate([t, x], axis=1)
    tj = tmlp._jet_embed(tm, tjet.seed(torch.from_numpy(xy), tjet.build_index(multis)))
    jj = jmlp._jet_embed(jm, jjet.seed(jnp.asarray(xy), jjet.build_index(multis)))
    _close_jets(tj, jj)


@pytest.mark.parametrize("multis", MULTIS[:2])
def test_mlp_forward_jet_plain_path(multis):
    """The pure jet path (the "jet" candidate) on both sides."""
    tm, jm = _models()
    t, x = _coords()
    xy = np.concatenate([t, x], axis=1)
    with tpath.override(tpath.CANDIDATES["jet"]):
        tj = tm.forward_jet(tjet.seed(torch.from_numpy(xy), tjet.build_index(multis)))
    with jpath.override(jpath.CANDIDATES["jet"]):
        jj = jm.forward_jet(jjet.seed(jnp.asarray(xy), jjet.build_index(multis)))
    _close_jets(tj, jj)
