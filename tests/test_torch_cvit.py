"""The port's CViT slice against paddlescience_tpu on the CPU: the sin-cos
position embeddings, ``CVit1D`` (grid and MLP query embeddings), ``CVit``
(a window of frames and a single frame), ``ContinuousNamedArrayDataset``,
and the adv_cvit and ns_cvit examples at a cut size.

Both packages get the same parameters (``load_jax_params``, conv kernels
transposed) and the same numpy-seeded inputs; JAX runs at "highest"
matmul precision. Tolerances (relative to the largest magnitude of the
JAX value): forwards 1e-5, parameter gradients 1e-4 (the attention key
biases, whose gradient is zero in exact arithmetic, within 1e-4 of the
largest gradient), the first three train steps of an example 1e-4;
embeddings 1e-6; data bitwise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _operator_parity import highest_precision  # noqa: F401
from paddlescience_tpu.arch import cvit as jcvit
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import cvit as tcvit
from paddlescience_torch.data.dataset.array_dataset import ContinuousNamedArrayDataset
from paddlescience_torch.examples import adv_cvit as tadv
from paddlescience_torch.examples import ns_cvit as tns
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import adv_cvit as jadv  # noqa: E402  (the JAX examples)
import ns_cvit as jns  # noqa: E402


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _arch_parity(jm, tm, inputs, seed=11):
    """Forward on the same numpy inputs and the parameter gradients of
    sum(out * c): forwards 1e-5, gradients 1e-4."""
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    params, rest = jm.param_tree(), jm.buffer_tree()

    def fwd(p):
        with jm.bind(p, rest):
            return jm({k: jnp.asarray(v) for k, v in inputs.items()})

    rng = np.random.default_rng(seed)
    cots = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jax.eval_shape(fwd, params).items()}

    def out_and_grads(p):
        out, vjp = jax.vjp(fwd, p)
        return out, vjp({k: jnp.asarray(c) for k, c in cots.items()})[0]

    jout, j_grads = jax.tree.map(np.asarray, jax.jit(out_and_grads)(params))
    j_grads = flatten_tree(j_grads)
    tout = tm({k: torch.from_numpy(v) for k, v in inputs.items()})
    for k in jout:
        _close(tout[k], jout[k], 1e-5)
    names, ps = zip(*tm.named_parameters())
    t_loss = sum((v * torch.from_numpy(cots[k])).sum() for k, v in tout.items())
    # a key projection's bias has a zero gradient in exact arithmetic (softmax ignores a shift of its
    # logits): both packages give float32 noise there, held to 1e-4 of the model's largest gradient
    floor = 1e-4 * max(np.abs(v).max() for v in j_grads.values())
    for n, g, p in zip(names, torch.autograd.grad(t_loss, ps, allow_unused=True), ps):
        want = j_grads[n]
        if type(tm.get_submodule(n.rpartition(".")[0])).__name__ == "Conv" and n.endswith("weight"):
            want = np.moveaxis(want, (-1, -2), (0, 1))
        got = (g if g is not None else torch.zeros_like(p)).numpy()
        if n.endswith("attn.k.bias"):
            np.testing.assert_allclose(got, want, rtol=0, atol=floor, err_msg=n)
        else:
            _close(got, want, 1e-4)


def test_sincos_embeddings_match_jax():
    _close(tcvit.get_1d_sincos_pos_embed(16, 9), np.asarray(jcvit.get_1d_sincos_pos_embed(16, 9)), 1e-6)
    _close(tcvit.get_2d_sincos_pos_embed(16, (3, 5)), np.asarray(jcvit.get_2d_sincos_pos_embed(16, (3, 5))), 1e-6)


CV1_KW = dict(spatial_dims=24, in_dim=1, coords_dim=1, patch_size=(4,), grid_size=(24,), latent_dim=8, emb_dim=8,
              depth=1, num_heads=2, dec_emb_dim=8, dec_num_heads=2, dec_depth=1, num_mlp_layers=1, mlp_ratio=2,
              out_dim=1)


@pytest.mark.parametrize("embedding", ["grid", "mlp"])
def test_cvit1d_matches_jax(embedding):
    jm = jcvit.CVit1D(("u", "y"), ("s",), embedding_type=embedding, rngs=Rngs(1), **CV1_KW)
    tm = tcvit.CVit1D(("u", "y"), ("s",), embedding_type=embedding, device="cpu", **CV1_KW)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, 24, 1)).astype(np.float32)
    y = np.sort(rng.uniform(0, 1, (10, 1)).astype(np.float32), axis=0)
    y = np.broadcast_to(y[None], (3, 10, 1)).copy()  # batched queries: the first row's are used
    _arch_parity(jm, tm, {"u": u, "y": y})


@pytest.mark.parametrize("frames", [3, 0], ids=["window", "single_frame"])
def test_cvit_matches_jax(frames):
    kw = dict(in_dim=2, coords_dim=2, grid_size=(8, 8), latent_dim=8, emb_dim=8, depth=1, num_heads=2, dec_emb_dim=8,
              dec_num_heads=2, dec_depth=1, num_mlp_layers=2, mlp_ratio=1, out_dim=2, layer_norm_eps=1e-6)
    if frames:
        kw.update(spatial_dims=(frames, 8, 8), patch_size=(1, 4, 4))
        shape = (2, frames, 8, 8, 2)
    else:
        kw.update(spatial_dims=(8, 8), patch_size=(4, 4))
        shape = (2, 8, 8, 2)
    jm = jcvit.CVit(("u", "y"), ("s",), rngs=Rngs(3), **kw)
    tm = tcvit.CVit(("u", "y"), ("s",), device="cpu", **kw)
    rng = np.random.default_rng(4)
    y = rng.uniform(0, 1, (12, 2)).astype(np.float32)
    _arch_parity(jm, tm, {"u": rng.standard_normal(shape).astype(np.float32), "y": y})


def test_continuous_dataset_yields_the_jax_packages_batches():
    from paddlescience_tpu.data.dataset.array_dataset import ContinuousNamedArrayDataset as JCont

    def make():
        rng = np.random.default_rng(5)
        inp = lambda: {"a": rng.standard_normal((4, 3)).astype(np.float32), "idx": rng.integers(0, 9, 4)}
        lab = lambda d: {"b": d.pop("idx").astype(np.float32)[:, None]}
        return inp, lab

    jit_, tit = iter(JCont(*make())), iter(ContinuousNamedArrayDataset(*make()))
    for _ in range(3):
        (ji, jl, _), (ti, tl, tw) = next(jit_), next(tit)
        assert set(ti) == {"a"} and np.array_equal(ti["a"], ji["a"]) and np.array_equal(tl["b"], jl["b"])
        assert tw == {}


def _three_steps(js, ts):
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    step_fn = js._build_train_step()
    j_logs = []
    for _ in range(3):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        js.state, logs = step_fn(js.state, host)
        j_logs.append([float(logs[k]) for k in ("loss", "lr")])
    t_logs = [[float(v) for k, v in ts.train_step().items() if k in ("loss", "lr")] for _ in range(3)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)


def test_adv_cvit_data_and_three_train_steps_match_jax(tmp_path):
    """The example with 64 functions, batches of 8 at 32 query points,
    embed 16, depth 1, 2 heads: the synthetic set bitwise, three steps on
    the same fresh batches, then the eval."""
    for a, b in zip(tadv.synth_adv(5, seed=3), jadv.synth_adv(5, seed=3)):
        assert np.array_equal(a, b)
    kw = dict(epochs=2, iters_per_epoch=3, batch_size=8, grid_size=32, n_data=64, data_dir=None, emb_dim=16, depth=1,
              num_heads=2)
    js = jadv.build_solver(output_dir=str(tmp_path / "jax"), **kw)
    ts = tadv.build_solver(output_dir=str(tmp_path / "port"), device="cpu", **kw)
    _three_steps(js, ts)
    j_metric, _ = js.eval()
    t_metric, _ = ts.eval()
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-4)


def test_ns_cvit_data_and_three_train_steps_match_jax(tmp_path):
    """Two trajectories of the pseudo-spectral solver (bitwise), windows of
    4 frames, batches of 4 at 64 query points, embed 16, depth 1."""
    assert np.array_equal(tns.spectral_ns2d(n_traj=1, nt=3), jns.spectral_ns2d(n_traj=1, nt=3))
    kw = dict(epochs=2, iters_per_epoch=3, batch_size=4, num_query_points=64, n_traj=2, emb_dim=16, depth=1,
              num_heads=2)
    js = jns.build_solver(output_dir=str(tmp_path / "jax"), **kw)
    ts = tns.build_solver(output_dir=str(tmp_path / "port"), device="cpu", **kw)
    _three_steps(js, ts)
    j_metric, _ = js.eval()
    t_metric, _ = ts.eval()
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-4)
