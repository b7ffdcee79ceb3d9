"""The port's bracket_elasticity example (two MLPs in a ModelList on a
Cuboid, the LinearElasticity mixed form) against the JAX example on the
CPU: its networks cut to 2 x 16 by wrapping ``psci.arch.MLP``, the same
points from one seed, and from the same weights three train steps with the
same per-constraint losses within 1e-4 relative.
"""

import os
import sys

import jax
import numpy as np

import paddlescience_tpu as psci
from paddlescience_torch.examples import bracket_elasticity as tbracket
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

from test_torch_elasticity import (STEPS, _jax_steps, _numpy_mesh_highest_precision,  # noqa: F401 (a fixture)
                                   _port_steps, _same_batches)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import bracket_elasticity as jbracket  # noqa: E402  (the JAX example)


def test_bracket_three_steps_match_jax(tmp_path, monkeypatch):
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, 2, 16, **kw))
    js = jbracket.build_solver(epochs=1, iters_per_epoch=1, output_dir=str(tmp_path))
    params0 = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    host, j_losses = _jax_steps(js, STEPS)
    ts = tbracket.build_solver(epochs=1, iters_per_epoch=1, output_dir=None, device="cpu", deriv="jet",
                               width=16, num_layers=2)
    assert list(ts.constraint) == list(js.constraint) and len(ts.models) == 2
    load_jax_params(ts.model, params0)
    _same_batches(ts, host)
    np.testing.assert_allclose(_port_steps(ts, STEPS), j_losses, rtol=1e-4)
