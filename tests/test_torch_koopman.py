"""The port's Koopman embeddings and Physformer against paddlescience_tpu
on the CPU: ``LorenzEmbedding`` (its outputs, the Koopman matrix and the
parameter gradients), ``CylinderEmbedding`` (outputs and the per-sample
Koopman matrices), ``PhysformerGPT2`` (forward, gradients, ``generate``),
the Lorenz, Rossler and cylinder windows (bitwise; the transformer
stage's embedded windows 1e-6), and three steps of lorenz_koopman, both
rossler stages and both physformer_lorenz stages (stage 1 the hand loop,
its parameters after three steps within 1e-4 of JAX's optax steps; the
losses 1e-4).

JAX runs at "highest" matmul precision (``_operator_parity.py``)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddlescience_tpu as psci
from _earthformer_parity import check_arch, fast_call, numpy_init, three_steps, one_torch_thread  # noqa: F401
from _operator_parity import close, highest_precision  # noqa: F401
from paddlescience_tpu.arch import embedding_koopman as jek
from paddlescience_tpu.arch import physx_transformer as jpx
from paddlescience_tpu.data.dataset import domain_dataset as jdd
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import embedding_koopman as tek
from paddlescience_torch.arch import physx_transformer as tpx
from paddlescience_torch.data.dataset import domain_dataset as tdd
from paddlescience_torch.examples import lorenz_koopman as tlk
from paddlescience_torch.examples import physformer_lorenz as tpl
from paddlescience_torch.examples import rossler as tros
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import lorenz_koopman as jlk  # noqa: E402  (the JAX examples)
import physformer_lorenz as jpl  # noqa: E402
import rossler as jros  # noqa: E402


def _lorenz(**kw):
    args = (("states",), ("pred", "recover", "k")), dict(mean=(1.0, -2.0, 20.0), std=(8.0, 9.0, 7.0),
                                                         hidden_size=16, embed_size=8, **kw)
    with numpy_init():
        jm = jek.LorenzEmbedding(*args[0], rngs=Rngs(1), **args[1])
    return jm, tek.LorenzEmbedding(*args[0], device="cpu", **args[1])


def test_lorenz_embedding_and_koopman_matrix_match_jax():
    jm, tm = _lorenz()
    x = np.random.default_rng(2).normal(0, 10, (3, 5, 3)).astype(np.float32)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    close(tm.get_koopman_matrix(), np.asarray(jm.get_koopman_matrix()), 1e-6)
    check_arch(jm, tm, {"states": x})


def test_cylinder_embedding_matches_jax():
    kw = dict(mean=(0.1, 0.2, -0.1, 0.01), std=(1.0, 0.5, 0.7, 0.02), embed_size=64,
              encoder_channels=(4, 4, 4, 4, 8), decoder_channels=(2, 8, 4, 4, 4))
    with numpy_init():
        jm = jek.CylinderEmbedding(("states", "visc"), ("pred", "recover", "k"), rngs=Rngs(3), **kw)
    tm = tek.CylinderEmbedding(("states", "visc"), ("pred", "recover", "k"), device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    rng = np.random.default_rng(4)
    inp = {"states": rng.standard_normal((2, 3, 3, 64, 128)).astype(np.float32),
           "visc": rng.uniform(1e-4, 1e-2, (2, 1)).astype(np.float32)}

    def fwd(p, x):
        with jm.bind(p, jm.buffer_tree()):
            return jm(x)

    want = fast_call(fwd, jm.param_tree(), {k: jnp.asarray(v) for k, v in inp.items()})
    got = tm({k: torch.from_numpy(v) for k, v in inp.items()})
    for k in ("pred", "recover", "k"):
        close(got[k], np.asarray(want[k]), 1e-5)


def test_physformer_forward_gradients_and_generate_match_jax():
    with numpy_init():
        jm = jpx.PhysformerGPT2(("e",), ("p",), num_layers=2, num_ctx=6, embed_size=8, num_heads=2, rngs=Rngs(5))
    tm = tpx.PhysformerGPT2(("e",), ("p",), num_layers=2, num_ctx=6, embed_size=8, num_heads=2, device="cpu")
    x = np.random.default_rng(6).standard_normal((2, 6, 8)).astype(np.float32)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    check_arch(jm, tm, {"e": x})

    def gen(p, x):
        with jm.bind(p, {}):
            return jm.generate(x, max_length=4)

    want = fast_call(gen, jm.param_tree(), jnp.asarray(x[:, :5]))
    with torch.no_grad():
        got = tm.generate(torch.from_numpy(x[:, :5]), max_length=4)
    assert got.shape == (2, 8, 8)  # the five given entries and max_length - 1 predictions, each from the last 6
    close(got, np.asarray(want), 1e-5)


def test_trajectory_windows_are_jax_bitwise():
    for jcls, tcls, kw in ((jdd.LorenzDataset, tdd.LorenzDataset, dict(ndata=3)),
                           (jdd.RosslerDataset, tdd.RosslerDataset, dict(ndata=2)),
                           (jdd.CylinderDataset, tdd.CylinderDataset, dict(ndata=2, H=8, W=16))):
        keys = (("x", "v"), ("next", "all"))
        j, t = jcls(None, *keys, block_size=16, stride=8, **kw), tcls(None, *keys, block_size=16, stride=8, **kw)
        for part in ("input", "label"):
            a, b = getattr(j, part), getattr(t, part)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(b[k], a[k])
    jm, tm = _lorenz()
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    j = jdd.LorenzDataset(None, ("e",), ("n",), block_size=16, stride=8, ndata=2, embedding_model=jm)
    t = tdd.LorenzDataset(None, ("e",), ("n",), block_size=16, stride=8, ndata=2, embedding_model=tm)
    close(t.input["e"], j.input["e"], 1e-6)


# ------------------------------------------------------------- examples --

def test_lorenz_koopman_three_steps_match_jax(tmp_path):
    with numpy_init():
        js = jlk.build_solver(epochs=2, output_dir=str(tmp_path / "jax"))
    three_steps(js, tlk.build_solver(epochs=2, output_dir=None, device="cpu"))


def _built_not_trained(monkeypatch):
    """The JAX Solver's train and eval as no-ops that keep the solver."""
    kept = []
    monkeypatch.setattr(psci.solver.Solver, "train", lambda self, *a, **k: kept.append(self))
    monkeypatch.setattr(psci.solver.Solver, "eval", lambda self, *a, **k: (0.0, {}))
    return kept


def test_rossler_stages_three_steps_match_jax(tmp_path, monkeypatch):
    kept = _built_not_trained(monkeypatch)
    with numpy_init():
        jemb, _, _ = jros.train_embedding(epochs=2, iters_per_epoch=4, output_dir=str(tmp_path / "jax"))
    params, buffers = (jax.tree.map(np.asarray, t) for t in (jemb.param_tree(), jemb.buffer_tree()))
    ts = tros.build_embedding(epochs=2, iters_per_epoch=4, output_dir=None, device="cpu")
    three_steps(kept[0], ts)
    # stage 2 over the same (untrained) embedding on both sides (the JAX steps took its arrays)
    jemb.load_param_tree(jax.tree.map(jnp.asarray, params))
    temb = tros.build_embedding(output_dir=None, device="cpu").model
    load_jax_params(temb, params, buffers)
    with numpy_init():
        js2 = jros.build_transformer(jemb, epochs=2, iters_per_epoch=4, output_dir=str(tmp_path / "jax2"))
    ts2 = tros.build_transformer(temb, epochs=2, iters_per_epoch=4, output_dir=None, device="cpu")
    close(ts2.constraint["Sup"].dataset.input["embeds"], js2.constraint["Sup"].dataset.input["embeds"], 1e-6)
    three_steps(js2, ts2)


def test_physformer_lorenz_stages_match_jax(tmp_path, monkeypatch):
    built = []
    orig = psci.arch.LorenzEmbedding

    def keep(*a, **kw):
        built.append(orig(*a, **kw))
        built.append(jax.tree.map(np.asarray, built[0].param_tree()))
        return built[0]

    monkeypatch.setattr(psci.arch, "LorenzEmbedding", keep)
    with numpy_init():
        jemb = jpl._pretrain_embedding(steps=3)
    stage1 = tpl.EmbeddingPretrain(device="cpu")
    load_jax_params(stage1.model, built[1], jax.tree.map(np.asarray, jemb.buffer_tree()))
    stage1.train(3)
    want = flatten_tree(jax.tree.map(np.asarray, jemb.param_tree()))
    for n, p in stage1.model.named_parameters():
        close(p, want[n], 1e-4)
    with numpy_init():
        js = jpl.build_solver(epochs=2, output_dir=str(tmp_path / "jax"), embedding_model=jemb)
    ts = tpl.build_solver(epochs=2, output_dir=None, embedding_model=stage1.model, device="cpu")
    three_steps(js, ts)
