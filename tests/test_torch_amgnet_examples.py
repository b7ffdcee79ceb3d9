"""The port's AMGNet examples (airfoil and cylinder) against
paddlescience_tpu on the CPU: three steps of the hand loop against the
JAX example's optax Adam loop, run through the example itself with
``jax.jit`` wrapped to record each step's loss (``_graph_parity.py``);
losses 1e-4. The JAX network is built from numpy draws and cut to hidden
16 and 2 layers (the examples' own 8 graphs; each step's graph is a new
compilation on the JAX side, hence a file of its own)."""

import os
import sys

import numpy as np
import pytest

import paddlescience_tpu as psci
from _earthformer_parity import one_torch_thread  # noqa: F401
from _graph_parity import CUT, capture_arch, port_losses, run_jax
from _operator_parity import highest_precision  # noqa: F401
from paddlescience_torch.examples import amgnet_airfoil as tamg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import amgnet_airfoil as jamg  # noqa: E402  (the JAX example)


@pytest.mark.parametrize("case", ["airfoil", "cylinder"])
def test_amgnet_three_steps_match_jax(case, monkeypatch):
    got = {}
    capture_arch(monkeypatch, psci.arch, "AMGNet", got, **CUT)
    want = run_jax(jamg.main, 3, case=case)
    np.testing.assert_allclose(port_losses(tamg.build(case, device="cpu", **CUT), got["params"]), want, rtol=1e-4)
