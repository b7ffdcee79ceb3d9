"""The port's NowcastNet (``paddlescience_torch/arch/nowcasting.py``)
against paddlescience_tpu on the CPU: ``warp`` in both modes on flows that
reach past the border (clipped) and land on half pixels (rounded half to
even), its output equal to JAX's ("nearest") or within 1e-6 ("bilinear")
and the cotangents of the field (and, bilinear, of the flow) within 1e-5
of their largest magnitude; and the model at the example's 32 x 32, 4 of
10 frames, ngf 16, with JAX's noise passed in, in float64 on both sides
(JAX's own float32 output is 1.4e-5 of the largest from its float64 one:
batch norms over 2 samples), outputs within 1e-5 of their largest
magnitude and parameter gradients within 1e-4 of the whole gradient's
(the motion decoder's 0 on both sides: the nearest warp passes no
gradient to the flow). TF32 off, JAX at "highest"; JAX modules built
from numpy draws, JAX functions compiled at XLA's lowest optimisation
level (``_earthformer_parity.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import fast_call, numpy_init, one_torch_thread  # noqa: F401
from _operator_parity import close, highest_precision  # noqa: F401
from _radar_parity import parity
from paddlescience_tpu.arch import nowcasting as jnow
from paddlescience_tpu.nn.core import Param
from paddlescience_torch.arch import nowcasting as tnow

T = torch.from_numpy


def _flow(rng, B, H, W):
    flow = rng.uniform(-3.0, 3.0, (B, 2, H, W))
    flow[:, :, 0, :3] = rng.uniform(-40.0, 40.0, (B, 2, 3))  # far past the border: clipped
    flow[:, :, 1, :4] = np.array([0.5, 1.5, -0.5, 2.5])  # half pixels: rounded half to even
    return flow.astype(np.float32)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_warp_matches_jax(mode):
    rng = np.random.default_rng(0)
    B, C, H, W = 2, 3, 9, 11
    field = rng.standard_normal((B, C, H, W)).astype(np.float32)
    flow = _flow(rng, B, H, W)
    cot = rng.standard_normal((B, C, H, W)).astype(np.float32)

    def j_warp(f, fl):
        out, vjp = jax.vjp(lambda a, b: jnow.warp(a, b, mode), f, fl)
        return (out,) + vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))

    jout, jdf, jdfl = (np.asarray(a) for a in fast_call(j_warp, jnp.asarray(field.transpose(0, 2, 3, 1)),
                                                         jnp.asarray(flow.transpose(0, 2, 3, 1))))
    tf, tfl = T(field).requires_grad_(), T(flow).requires_grad_()
    tout = tnow.warp(tf, tfl, mode)
    tdf, tdfl = torch.autograd.grad(tout, (tf, tfl), T(cot), allow_unused=True)
    want = jout.transpose(0, 3, 1, 2)
    if mode == "nearest":
        np.testing.assert_array_equal(tout.detach().numpy(), want)
        assert tdfl is None and not np.any(jdfl)
    else:
        close(tout, want, 1e-6)
        close(tdfl, jdfl.transpose(0, 3, 1, 2), 1e-5)
    close(tdf, jdf.transpose(0, 3, 1, 2), 1e-5)


def test_nowcastnet_matches_jax():
    kw = dict(input_length=4, total_length=10, image_height=32, image_width=32, ngf=16)
    with numpy_init():
        jm = psci.arch.NowcastNet(("x",), ("y",), **kw)
    tm = tnow.NowcastNet(("x",), ("y",), **kw, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 1.0, (2, 10, 32, 32, 1))
    with jax.enable_x64(True):  # the JAX module's own draw in its float64 call
        noise = np.asarray(jax.random.normal(jm._rng, (2, 1, 1, 16), jnp.float64))
    tm.set_noise(T(noise.transpose(0, 3, 1, 2).copy()))
    jm.evo_net.gamma = Param(jnp.full((1, 1, 1, 6), 0.5))  # the intensity gate open (0 at init), carried across
    out = parity(jm, tm, lambda m: m({"x": jnp.asarray(x)}), lambda m: m({"x": T(x)}), x64=True)
    assert out["y"].shape == (2, 6, 32, 32, 1)
    y = tm({"x": T(x)})["y"]  # float64 now
    grads = torch.autograd.grad(y.sum(), list(tm.evo_net.outc_v.parameters()), allow_unused=True)
    assert all(g is None or not g.any() for g in grads)  # no gradient reaches the motion decoder
