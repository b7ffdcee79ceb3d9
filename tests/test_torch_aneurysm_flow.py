"""The port's aneurysm_flow example against paddlescience_tpu on the CPU.

The JAX example is built as it stands from a temporary working directory
(it writes its tube under ``./dataset``), its network cut to MLP 3 x 32
by wrapping ``psci.arch.MLP`` and its constraints to one iteration's
points (256 interior, 64 wall, 32 at each end) by wrapping the constraint
classes; the port's builder gets the same sizes. Both write the same STL
bytes and, from one seed, sample the same points (the JAX mesh code
pinned to its numpy branch, the port's on its C++ ray cast: the sdf
weights within 1e-6). From the same weights, three train steps on the
JAX ``jet`` path and on the port's ``jet_pallas_full`` path (the kernels'
plain versions here) give per-constraint losses within 1e-4 relative and
parameters within 1e-4, and the centerline-w report agrees within 1e-4.
"""

import os
import sys

import jax
import numpy as np
import pytest

import paddlescience_tpu as psci
from paddlescience_tpu import native as jnative
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import aneurysm_flow as tflow
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

from test_torch_elasticity import _jax_steps, _port_steps, _same_batches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import aneurysm_flow as jflow  # noqa: E402  (the JAX example)

STEPS, LR = 3, 1e-3
WIDTH, LAYERS = 32, 3
SIZES = {"EQ": 256, "WALL": 64, "INLET": 32, "OUTLET": 32}


@pytest.fixture(autouse=True)
def _numpy_mesh_highest_precision(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _cut(cls):
    def build(*args, name, **kw):
        args = list(args)
        args[3] = {**args[3], "batch_size": SIZES[name], "iters_per_epoch": 1}  # the dataloader config
        return cls(*args, name=name, **kw)

    return build


def test_aneurysm_flow_steps_match_jax(tmp_path, monkeypatch):
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, LAYERS, WIDTH, **kw))
    for cls in ("InteriorConstraint", "BoundaryConstraint"):
        monkeypatch.setattr(psci.constraint, cls, _cut(getattr(psci.constraint, cls)))
    monkeypatch.chdir(tmp_path)
    js = jflow.build_solver(epochs=1, output_dir=str(tmp_path / "jax"))
    stl = str(tmp_path / "port" / "aneurysm_tube.stl")
    ts = tflow.build_solver(epochs=1, output_dir=None, stl_path=stl, sample_iters=1, n_interior=SIZES["EQ"],
                            n_wall=SIZES["WALL"], n_end=SIZES["INLET"], width=WIDTH, num_layers=LAYERS, device="cpu",
                            deriv="jet_pallas_full")
    assert open(stl, "rb").read() == (tmp_path / "dataset" / "aneurysm_tube.stl").read_bytes()
    assert list(ts.constraint) == list(js.constraint) == ["EQ", "WALL", "INLET", "OUTLET"]
    assert ts.model.jet_segment_lengths() == [LAYERS]
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    host, j_losses = _jax_steps(js, STEPS, "jet")
    _same_batches(ts, host, sdf_rtol=1e-6)
    np.testing.assert_allclose(_port_steps(ts, STEPS), j_losses, rtol=1e-4)
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    for n, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=1e-4, atol=1e-2 * LR, err_msg=n)
    np.testing.assert_allclose(tflow.centerline_w(ts), jflow._report(js), rtol=1e-4, atol=1e-6)
