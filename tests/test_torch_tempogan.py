"""The port's tempoGAN pair and tempogan_lite against paddlescience_tpu
on the CPU: the Generator and the Discriminator (stride-2 "SAME"
convolutions, the flatten before ``fc`` in (H, W, C) order), outputs and
parameter gradients within 1e-5 of their largest magnitude (the whole
gradient's, for a parameter), at narrow widths; tempogan_lite's frames
from the plain LBM step within 1e-5 of the JAX example's over 100 steps
of the 64 x 64 cavity, and its first discriminator and generator steps
(the JAX example's own, run with ``jax.jit`` wrapped to record them,
``_misc_parity.py``) on 16 x 16 frames: losses 1e-4, parameters 1e-4 of
the largest magnitude. JAX modules are built from numpy draws and their
functions compiled at XLA's lowest optimisation level
(``_earthformer_parity.py``)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

import paddlescience_tpu as psci
from _earthformer_parity import numpy_init, one_torch_thread  # noqa: F401
from _graph_parity import capture_arch, grads_parity
from _operator_parity import highest_precision  # noqa: F401
from _misc_parity import params_close, recorded, run_jax
from paddlescience_torch import arch as tarch
from paddlescience_torch.examples import tempogan_lite as ttempo
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import tempogan_lite as jtempo  # noqa: E402  (the JAX example)

T = torch.from_numpy
RNG = np.random.default_rng


def _dict_parity(jm, tm, inputs):
    return grads_parity(jm, tm, lambda m: m({k: jnp.asarray(v) for k, v in inputs.items()}),
                        lambda m: m({k: T(v) for k, v in inputs.items()}))


GEN = dict(in_channel=1, out_channels_tuple=((4, 4), (4, 1)), kernel_sizes_tuple=((3, 3), (3, 5)),
           strides_tuple=((1, 2), (1, 1)), use_bns_tuple=((False, False),) * 2,
           acts_tuple=(("relu", "leaky_relu"), ("tanh", None)))


def test_generator_matches_jax():
    with numpy_init():
        jm = psci.arch.Generator(("in",), ("out",), **GEN)
    tm = tarch.Generator(("in",), ("out",), **GEN, device="cpu")
    out = _dict_parity(jm, tm, {"in": RNG(7).standard_normal((2, 1, 9, 9)).astype(np.float32)})
    assert out["out"].shape == (2, 1, 5, 5)  # the stride-2 "SAME" convolution of an odd edge


def test_discriminator_matches_jax():
    kw = dict(in_channel=1, out_channels=(3, 5), fc_channel=5 * 4 * 3, kernel_sizes=(3, 3), strides=(2, 2),
              use_bns=(False, False), acts=("leaky_relu", "leaky_relu"))
    with numpy_init():
        jm = psci.arch.Discriminator(("a", "b"), ("f1", "f2", "score", "g1", "g2", "score_b"), **kw)
    tm = tarch.Discriminator(("a", "b"), ("f1", "f2", "score", "g1", "g2", "score_b"), **kw, device="cpu")
    rng = RNG(8)
    inputs = {"a": rng.standard_normal((2, 1, 13, 10)).astype(np.float32),
              "b": rng.standard_normal((2, 1, 13, 10)).astype(np.float32)}
    out = _dict_parity(jm, tm, inputs)
    assert out["f2"].shape == (2, 5, 4, 3) and out["score_b"].shape == (2, 1)


def test_tempogan_frames_and_first_pair_match_jax(monkeypatch):
    with recorded([]):  # its 50-step scan compiled at the lowest optimisation level too
        jframes = np.asarray(jtempo.make_lbm_frames(2, 64))  # 100 steps of the 64 x 64 cavity
    tframes = ttempo.make_lbm_frames(2, 64, device="cpu")  # the plain LBM step on a CPU lattice
    np.testing.assert_allclose(tframes.numpy(), jframes, rtol=1e-5, atol=1e-5 * np.abs(jframes).max())
    jframes = np.ascontiguousarray(jframes[:2, :, ::4, ::4])  # the GAN cut to 16 x 16 frames
    gen, disc = {}, {}
    capture_arch(monkeypatch, psci.arch, "Generator", gen)
    capture_arch(monkeypatch, psci.arch, "Discriminator", disc)
    monkeypatch.setattr(jtempo, "make_lbm_frames", lambda n, nx: jframes)  # both sides train on the same frames
    records = run_jax(jtempo.train, 1, n_frames=2, nx=16)
    gan = ttempo.TempoGAN(2, 16, device="cpu", frames=torch.from_numpy(jframes))
    load_jax_params(gan.gen, gen["params"])
    load_jax_params(gan.disc, disc["params"])
    logs = gan.train_steps(1)
    (_, (dp, _, d_loss)), = [r for r in records if r[0] == "d_step"]
    (_, (gp, _, pix, adv)), = [r for r in records if r[0] == "g_step"]
    for key, want in (("d_loss", d_loss), ("pix", pix), ("adv", adv)):
        np.testing.assert_allclose(logs[key], float(want), rtol=1e-4, err_msg=key)
    params_close(dp, gan.disc)
    params_close(gp, gan.gen)
