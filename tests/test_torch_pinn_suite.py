"""The port's small PINN examples on the ported equations (burgers,
shock_wave, nlsmb_soliton, nlsmb_rogue_wave, heat_exchanger) against
paddlescience_tpu on the CPU.

Each JAX example is built as it stands, its network cut to 3 layers of
width 16 by wrapping ``psci.arch.MLP`` and its interior constraint to 128
points of one iteration by wrapping ``InteriorConstraint``; the port's
builder gets the same sizes. The host data are the same arrays bitwise;
from the same weights, three train steps on the ``jet`` path (nested jvp
for shock_wave's composed expressions, as in JAX) give losses within 1e-4
relative. The built-in references (the spectral Burgers solution, the
soliton and the rogue wave) are the JAX example's numpy functions'
arrays bitwise.
"""

import os
import sys

import jax
import numpy as np
import pytest

import paddlescience_tpu as psci
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import burgers, heat_exchanger, nlsmb_rogue_wave, nlsmb_soliton, shock_wave
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

from test_torch_elasticity import _jax_steps, _port_steps, _same_batches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

STEPS, WIDTH, LAYERS, N_INTERIOR = 3, 16, 3, 128
EXAMPLES = {  # name: (port module, the JAX example's build arguments)
    "burgers": (burgers, dict(epochs=1)),
    "shock_wave": (shock_wave, dict(epochs=1)),
    "nlsmb_soliton": (nlsmb_soliton, dict(epochs=1)),
    "nlsmb_rogue_wave": (nlsmb_rogue_wave, dict(epochs=1)),
    "heat_exchanger": (heat_exchanger, dict(epochs=1, iters_per_epoch=STEPS)),
}


@pytest.fixture(autouse=True)
def _highest_precision():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _cut_interior(cls):
    def build(*args, **kw):
        args = list(args)
        args[3] = {**args[3], "batch_size": N_INTERIOR, "iters_per_epoch": 1}  # the dataloader config
        return cls(*args, **kw)

    return build


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_three_train_steps_match_jax(name, tmp_path, monkeypatch):
    module, jax_kw = EXAMPLES[name]
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, LAYERS, WIDTH, **kw))
    monkeypatch.setattr(psci.constraint, "InteriorConstraint", _cut_interior(psci.constraint.InteriorConstraint))
    jmod = __import__(name)
    js = jmod.build_solver(output_dir=str(tmp_path / "jax"), **jax_kw)
    port_kw = dict(width=WIDTH, num_layers=LAYERS, device="cpu", deriv="jet")
    if name == "heat_exchanger":
        port_kw.update(iters_per_epoch=STEPS)
    else:
        port_kw.update(sample_iters=1, n_interior=N_INTERIOR)
    ts = module.build_solver(epochs=1, output_dir=None, **port_kw)
    assert list(ts.constraint) == list(js.constraint)
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    host, j_losses = _jax_steps(js, STEPS, "jet")
    _same_batches(ts, host)
    t_losses = _port_steps(ts, STEPS)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert np.isfinite(t_losses).all()


REFERENCES = {  # name: (port function, JAX module, its function, arguments)
    "burgers_spectral": (burgers.solve_burgers_spectral, "burgers", "solve_burgers_spectral", ()),
    "soliton": (nlsmb_soliton.soliton, "nlsmb_soliton", "_soliton", "grid"),
    "rogue_wave": (nlsmb_rogue_wave.rogue, "nlsmb_rogue_wave", "_rogue", "grid"),
}


@pytest.mark.parametrize("name", list(REFERENCES))
def test_references_are_the_jax_examples(name):
    fn, jname, jfn, args = REFERENCES[name]
    if args == "grid":
        t, x = np.meshgrid(np.linspace(-1, 1, 32), np.linspace(-1, 1, 64), indexing="ij")
        args = (t.reshape(-1, 1), x.reshape(-1, 1))
    got, ref = fn(*args), getattr(__import__(jname), jfn)(*args)
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        got, ref = list(got.values()), list(ref.values())
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
