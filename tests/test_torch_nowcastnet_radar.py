"""The port's nowcastnet_radar example against paddlescience_tpu's on
the CPU: three ``Solver`` steps from the same parameters, JAX's noise
passed in, in float64 on both sides (``_radar_parity.x64_steps``): after
each step the losses and Adam's moments within 1e-4 of their largest
magnitude and the parameters within 1e-6 of theirs; the motion decoder,
which the nearest warp passes no gradient, unmoved on both sides. In
float32 the two sides' moments are 9e-4 of their largest magnitude apart
after one step and 1.5e-2 after two (at the initial weights 18% of
``gen_dec.fc``'s gradient entries change sign between JAX's own float32
and float64, and Adam's first steps move each entry by the learning rate
in its gradient's sign); float64 leaves them 4e-12 apart. JAX at
"highest"; JAX modules built from numpy draws, JAX functions compiled at
XLA's lowest optimisation level (``_earthformer_parity.py``)."""

import os
import sys

import jax
import numpy as np
import torch

from _earthformer_parity import numpy_init, one_torch_thread  # noqa: F401
from _operator_parity import highest_precision  # noqa: F401
from _radar_parity import x64_steps
from paddlescience_torch.examples import nowcastnet_radar as tnr
from paddlescience_torch.utils.jax_params import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
import nowcastnet_radar as jnr  # noqa: E402  (the JAX example)

T = torch.from_numpy


def test_nowcastnet_radar_three_steps_match_jax(tmp_path):
    with numpy_init():
        js = jnr.build_solver(epochs=1, output_dir=str(tmp_path / "jax"))
    ts = tnr.build_solver(epochs=1, output_dir=str(tmp_path / "torch"), device="cpu")
    with jax.enable_x64(True):  # the JAX module's draw at batch 4 in its float64 step
        noise = np.asarray(jax.random.normal(js.model._rng, (4, 1, 1, 16), jax.numpy.float64))
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]),  # the spectral norms' u0 too
                    jax.tree.map(np.asarray, js.model.buffer_tree()))
    ts.model.set_noise(T(noise.transpose(0, 3, 1, 2).copy()))
    x64_steps(js, ts)
