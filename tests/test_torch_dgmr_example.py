"""The port's dgmr example against paddlescience_tpu's on the CPU: three
steps of the example (the JAX example's own loop, its jitted steps
recorded; 4 forecast frames, the fewest the temporal discriminator's two
3-D blocks leave a slice of) with JAX's latent noise passed in: losses
within 1e-4, and the d, g and grid-cell losses of JAX's trained generator
under the untrained discriminator pair within 1e-4 (the two sides'
parameters after the steps are not compared: Adam's first steps move each
entry by the learning rate in its gradient's sign, which float32 rounding
decides for entries whose gradient is near 0, and this generator's
forecast moves by up to 40% under such a difference). TF32 off, JAX at
"highest"; JAX modules built from numpy draws, JAX functions compiled at
XLA's lowest optimisation level (``_earthformer_parity.py``)."""

import os
import sys

import jax
import numpy as np
import torch

import paddlescience_tpu as psci
from _earthformer_parity import one_torch_thread  # noqa: F401
from _misc_parity import run_jax
from _operator_parity import highest_precision  # noqa: F401
from _radar_parity import capture_fast
from paddlescience_torch.arch.dgmr import DGMRDiscriminators
from paddlescience_torch.examples import dgmr as tdgmr_ex
from paddlescience_torch.utils.jax_params import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
import dgmr as jdgmr_ex  # noqa: E402  (the JAX example)

T = torch.from_numpy


def test_dgmr_example_three_steps_and_scores_match_jax(monkeypatch):
    model, disc = {}, {}
    capture_fast(monkeypatch, psci.arch, "DGMR", model)
    capture_fast(monkeypatch, psci.arch, "DGMRDiscriminators", disc)
    j_grid = []
    records = run_jax(lambda: j_grid.append(jdgmr_ex.run(epochs=3, t_out=4)))
    jm = model["model"]
    c, h, w = jm.latent_stack.shape
    noise = np.asarray(jax.random.normal(jax.random.split(jm._rng, 1)[0], (1, h, w, c)))  # the JAX module's draw
    fit = tdgmr_ex.DGMRFit(t_out=4, device="cpu")
    load_jax_params(fit.model, model["params"], model["buffers"])
    fit.model.set_noise(T(noise.transpose(0, 3, 1, 2)[None].copy()))
    tdisc = DGMRDiscriminators(input_channels=1, device="cpu")
    load_jax_params(tdisc, disc["params"], disc["buffers"])
    losses = []
    monkeypatch.setattr(fit.loop, "run", lambda k, graphed=True, real=fit.loop.run: losses.append(
        real(k, graphed)) or losses[-1])
    grid, scores = tdgmr_ex.run(3, t_out=4, fit=fit, disc=tdisc)
    steps = [r for r in records if r[0] == "step"]
    np.testing.assert_allclose([float(v["loss"]) for v in losses], [float(r[1][2]) for r in steps], rtol=1e-4)
    assert all(np.isfinite(v) for v in scores.values()) and grid == scores["grid_loss"]
    # the scores of JAX's trained generator: the port's forecast and discriminators on its parameters
    load_jax_params(fit.model, steps[-1][1][0])
    (sr, tr), (sg, tg) = disc["calls"]  # the JAX example scores the real frames, then the generated ones
    real, gen = sr + tr, sg + tg
    want = {"grid_loss": j_grid[0], "g_loss": -np.mean(gen) + 20 * j_grid[0],
            "d_loss": np.mean(np.maximum(1.0 - real, 0.0)) + np.mean(np.maximum(1.0 + gen, 0.0))}
    with torch.no_grad():
        got = tdgmr_ex.hinge_scores(tdisc, fit.y, fit.forecast())
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-4, err_msg=k)
