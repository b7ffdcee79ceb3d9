"""The port's DGMR (``paddlescience_torch/arch/dgmr.py``) against
paddlescience_tpu on the CPU, the same weights and spectral-norm buffers
carried across with ``load_jax_params`` and JAX's latent noise passed in:
the model at 64 x 64 (4 context frames, 2 forecast steps, latent and
context 32) with 1 and 2 generation steps, in float64 on both sides (one
JAX compilation of the 2-sample model serves both: a 1-sample model fed
either draw computes that sample), since its batch norms over 2 samples
carry float32 rounding to about 2e-5 of the largest output in JAX and in
the port alike (the float32 model trains in the dgmr example's parity
test); the discriminator pair at the example's depth and at two layers
each, in float32: outputs within 1e-5 of their largest magnitude and
parameter gradients within 1e-4 of the largest magnitude of the whole
gradient; the space-to-depth in JAX's channel order; a spectral-normed
convolution's kernel (within 1e-5 of JAX's) and its largest singular
value after a 3x scaling (1 within 0.1); and the default 768 / 384 wide
model's parameter and buffer names, shapes and count. TF32 off (the
port's import), JAX at "highest"; JAX modules built from numpy draws,
JAX functions compiled at XLA's lowest optimisation level
(``_earthformer_parity.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import FAST, numpy_init, one_torch_thread  # noqa: F401
from _operator_parity import close, highest_precision  # noqa: F401
from _radar_parity import parity
from paddlescience_tpu.arch import dgmr as jdgmr
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import dgmr as tdgmr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

T = torch.from_numpy
SMALL = dict(forecast_steps=2, input_channels=1, output_shape=64, latent_channels=32, context_channels=32,
             num_input_frames=4)


def _context(seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, 4, 1, 64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_dgmr():
    """JAX's 2-sample DGMR in float64: its outputs and the parameter
    gradient of sum(out * c) over them, from one compilation. Returns
    (model, draws, input, cotangents, outputs, gradient)."""
    with numpy_init():
        jm = psci.arch.DGMR(("x",), ("y",), generation_steps=2, **SMALL)
    key = jax.random.PRNGKey(7)
    jm.set_rng(key)
    shape = (1,) + tuple(jm.latent_stack.shape[1:]) + (jm.latent_stack.shape[0],)  # JAX's (1, h, w, c)
    x = _context().astype(np.float64)
    rng = np.random.default_rng(11)
    cots = {"y": rng.standard_normal((2, 2, 1, 64, 64)), "samples": rng.standard_normal((2, 2, 2, 1, 64, 64))}
    with jax.enable_x64(True):
        draws = [np.asarray(jax.random.normal(k, shape, jnp.float64)) for k in jax.random.split(key, 2)]
        cast = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        params, rest = jax.tree.map(cast, jm.param_tree()), jax.tree.map(cast, jm.buffer_tree())

        def out_and_grads(p):
            def fwd(q):
                with jm.bind(q, rest):
                    return jm({"x": jnp.asarray(x)})

            out, vjp = jax.vjp(fwd, p)
            return out, vjp({k: jnp.asarray(c) for k, c in cots.items()})[0]

        out, grads = jax.tree.map(np.asarray, jax.jit(out_and_grads).lower(params).compile(
            compiler_options=FAST)(params))
    return jm, draws, x, cots, out, flatten_tree(grads)


@pytest.mark.parametrize("steps", [1, 2])
def test_dgmr_matches_jax(jax_dgmr, steps):
    """generation_steps 2 against JAX's outputs and gradient; generation_steps
    1 run once with each draw: its outputs against JAX's two samples, and
    the sum of its two gradients, under the cotangents the mean passes to
    each sample (c_y / 2 + c_s), against JAX's gradient."""
    jm, draws, x, cots, jout, want = jax_dgmr
    tm = tdgmr.DGMR(("x",), ("y",), generation_steps=steps, **SMALL, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    tm.double()
    noise = np.stack(draws).transpose(0, 1, 4, 2, 3)  # -> (S, 1, c, h, w)
    if steps == 2:
        tm.set_noise(T(noise.copy()))
        out = tm({"x": T(x)})
        assert set(out) == {"y", "samples"}
        for k in out:
            close(out[k], jout[k], 1e-5)
        loss = sum((out[k] * T(cots[k])).sum() for k in out)
    else:
        loss = 0.0
        for s in range(2):
            tm.set_noise(T(noise[s: s + 1].copy()))
            out = tm({"x": T(x)})
            assert set(out) == {"y"}
            close(out["y"], jout["samples"][s], 1e-5)
            loss = loss + (out["y"] * T(cots["y"] / 2 + cots["samples"][s])).sum()
    names, ps = zip(*tm.named_parameters())
    assert set(names) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for n, g, p in zip(names, torch.autograd.grad(loss, ps, allow_unused=True), ps):
        w = want[n]
        if n.endswith("weight") and p.ndim > 2:  # conv kernels: JAX's (*window, in, out)
            w = np.moveaxis(w, (-1, -2), (0, 1))
        got = (g if g is not None else torch.zeros_like(p)).detach().numpy()
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4 * scale, err_msg=n)


@pytest.mark.parametrize("kind", ["example", "two_layers"])
def test_discriminators_match_jax(kind):
    if kind == "example":
        make = lambda mod, **kw: mod.DGMRDiscriminators(input_channels=1, **kw)  # noqa: E731
    else:
        make = lambda mod, **kw: mod.DGMRDiscriminator(input_channels=1, num_spatial_frames=2,  # noqa: E731
                                                       spatial_layers=2, temporal_layers=2, **kw)
    with numpy_init():
        jm = make(jdgmr, rngs=Rngs(1))
    tm = make(tdgmr, device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 4, 1, 64, 64)).astype(np.float32)

    def as_dict(out):
        return {"s": out[0], "t": out[1]} if isinstance(out, tuple) else {"scores": out}

    out = parity(jm, tm, lambda m: as_dict(m(jnp.asarray(x))), lambda m: as_dict(m(T(x))))
    assert all(v.shape[0] == 2 for v in out.values())


def test_pixel_unshuffle_keeps_the_jax_channel_order():
    x = np.random.default_rng(4).standard_normal((2, 3, 8, 6)).astype(np.float32)
    want = np.asarray(jdgmr.pixel_unshuffle(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(tdgmr.pixel_unshuffle(T(x), 2).numpy(), want)


def test_snconv_kernel_matches_jax_and_normalises():
    with numpy_init():
        jm = jdgmr.SNConv(6, 10, (3, 3), padding="SAME", rngs=Rngs(0))
    tm = tdgmr.SNConv(6, 10, (3, 3), padding="SAME", generator=torch.Generator().manual_seed(0))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    want = np.moveaxis(np.asarray(jm._kernel()), (-1, -2), (0, 1))
    got = tm._kernel().detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with torch.no_grad():
        tm.weight.mul_(3.0)
    sigma = float(torch.linalg.matrix_norm(tm._kernel().detach().flatten(1), ord=2))
    assert abs(sigma - 1.0) <= 0.1, sigma


def test_default_dgmr_parameters_load_by_their_jax_names():
    with numpy_init():
        jm = psci.arch.DGMR(("x",), ("y",), output_shape=64)
    tm = tdgmr.DGMR(("x",), ("y",), output_shape=64, device="cpu")
    params = flatten_tree(jax.tree.map(np.asarray, jm.param_tree()))
    buffers = flatten_tree(jax.tree.map(np.asarray, jm.buffer_tree()))
    load_jax_params(tm, params, buffers)  # every name and shape, or it raises
    assert set(buffers) == {n for n, _ in tm.named_buffers()}
    count = sum(v.size for v in params.values())
    assert count == sum(p.numel() for p in tm.parameters()) == 53566957
    for name in ("conditioning_stack.d1.conv_1x1.u0", "sampler.convGRU1.cell.read_gate_conv.weight",
                 "latent_stack.att_block.gamma", "sampler.up_g4.bn2.scale"):
        assert name in params or name in buffers, name
    w = params["sampler.convGRU1.cell.read_gate_conv.weight"]
    np.testing.assert_array_equal(tm.sampler.convGRU1.cell.read_gate_conv.weight.detach().numpy(),
                                  np.moveaxis(w, (-1, -2), (0, 1)))
