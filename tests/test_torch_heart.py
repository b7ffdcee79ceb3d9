"""The port's heart example (forward and inverse) against paddlescience_tpu
on the CPU.

Each JAX example is built as it stands, its network cut to MLP 3 x 32 by
wrapping ``psci.arch.MLP`` (as ``test_torch_elasticity.py`` cuts the
control arm), with 256 interior points, 32 on each boundary and 64 data
points, one iteration's worth; the port's builder gets the same sizes.
Both packages write the same STL bytes, and from one seed sample the same
points (the JAX mesh code pinned to its numpy branch, the port's on its
C++ ray cast, whose sdf column agrees within 1e-6) and the same synthetic
data. From the same weights, three train steps on the JAX ``jet`` path and
on the port's ``jet_pallas_full`` path (the kernels' plain versions here)
give per-constraint losses within 1e-4 relative and parameters within
1e-4; the inverse also dL/dE on the first batch within 1e-4 (before
the steps), E within 1e-5 and the validator's L2Rel within 1e-4, and
after 50 steps the losses within 1e-3 and E's change within 1e-3. At the
10 streams of the 3-D Hooke jet the kernels' plain versions agree with
the JAX Pallas segment (interpreted) and its VJP within 1e-5.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu import native as jnative
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import heart as theart
from paddlescience_torch.ops import jet_mlp as J
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_eq_params, load_jax_params

from test_torch_elasticity import _jax_steps, _port_steps, _same_batches
from test_torch_jet_mlp import _case, _jax_segment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import heart as jheart  # noqa: E402  (the JAX example)

STEPS, LR = 3, 1e-3
SIZES = dict(n_interior=256, n_bc=32, n_data=64)
WIDTH, LAYERS = 32, 3
HOOKE_3D = [(0,), (1,), (2,), (0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]  # S = 10


@pytest.fixture(autouse=True)
def _numpy_mesh_highest_precision(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _build(problem, tmp_path, monkeypatch):
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, LAYERS, WIDTH, **kw))
    js = jheart.build_solver(problem, epochs=1, iters_per_epoch=1, output_dir=str(tmp_path / "jax"),
                             geom_dir=str(tmp_path / "jax_geo"), **SIZES)
    ts = theart.build_solver(problem, epochs=1, iters_per_epoch=1, output_dir=None,
                             geom_dir=str(tmp_path / "port_geo"), width=WIDTH, num_layers=LAYERS, device="cpu",
                             deriv="jet_pallas_full", **SIZES)
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    return js, ts


def _same_data(js, ts):
    for part in ("input", "label"):
        j_part, t_part = getattr(js.constraint["DATA"].dataset, part), getattr(ts.constraint["DATA"].dataset, part)
        assert set(j_part) == set(t_part)
        for k in j_part:
            np.testing.assert_array_equal(np.asarray(t_part[k]), np.asarray(j_part[k]), err_msg=k)


def _close_params(ts, js):
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    for n, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=1e-4, atol=1e-2 * LR, err_msg=n)


@pytest.mark.parametrize("problem", ["forward", "inverse"])
def test_heart_steps_match_jax(problem, tmp_path, monkeypatch):
    js, ts = _build(problem, tmp_path, monkeypatch)
    for k in theart.PARTS:
        name = f"heart_{k}.stl"
        assert (tmp_path / "port_geo" / name).read_bytes() == (tmp_path / "jax_geo" / name).read_bytes(), name
    assert list(ts.constraint) == list(js.constraint) == ["BC_BASE", "BC_ENDO", "BC_EPI", "INTERIOR", "DATA"]
    assert ts.model.jet_segment_lengths() == [LAYERS]
    _same_data(js, ts)
    if problem == "inverse":
        assert set(ts.eq_params) == set(js.state["eq_params"]) == {"E"}
        load_jax_eq_params(ts.eq_params, {k: np.asarray(v) for k, v in js.state["eq_params"].items()})
        assert float(ts.eq_params["E"].detach()) == 18.0
        _same_de(js, ts)
    host, j_losses = _jax_steps(js, STEPS, "jet")
    _same_batches(ts, {n: v for n, v in host.items() if n != "DATA"}, sdf_rtol=1e-6)
    np.testing.assert_allclose(_port_steps(ts, STEPS), j_losses, rtol=1e-4)
    _close_params(ts, js)
    if problem == "inverse":
        e_jax, e_port = float(js.state["eq_params"]["E"]), float(ts.eq_params["E"].detach())
        assert e_port != 18.0
        np.testing.assert_allclose(e_port, e_jax, rtol=1e-5)
        j_metric, j_group = js.eval()
        t_metric, t_group = ts.eval()
        assert set(t_group["ref_u_v_w"]) == set(j_group["ref_u_v_w"]) == {"L2Rel.u", "L2Rel.v", "L2Rel.w"}
        for k, v in j_group["ref_u_v_w"].items():
            np.testing.assert_allclose(t_group["ref_u_v_w"][k], v, rtol=1e-4, err_msg=k)
        rep = theart.report(ts)
        assert rep["E_hat"] == e_port and rep["E_rel_err"] == abs(e_port - 9.0) / 9.0
        # E over 50 steps: the port moves it as the JAX solver does, change for change
        _, j_more = _jax_steps(js, 50 - STEPS, "jet")
        np.testing.assert_allclose(_port_steps(ts, 50 - STEPS), j_more, rtol=1e-3)
        e_jax, e_port = float(js.state["eq_params"]["E"]), float(ts.eq_params["E"].detach())
        np.testing.assert_allclose(e_port - 18.0, e_jax - 18.0, rtol=1e-3)


def _same_de(js, ts):
    """dL/dE itself on the first batch (Adam's first steps show only its
    sign) against the JAX solver's, at rtol 1e-4."""
    import jax.numpy as jnp

    from paddlescience_tpu.autodiff import path as jpath

    host = {n: jax.tree.map(jnp.asarray, next(js.constraint[n].data_iter)) for n in js.constraint}
    j_total = lambda e: sum(js._constraint_losses(js.state["params"], js.state["rest"], {"E": e}, host).values())
    with jpath.override(jpath.CANDIDATES["jet"]):
        j_de = float(jax.grad(j_total)(js.state["eq_params"]["E"]))
    ts._stage_host_batches(1)
    ts._chunk_pos = 0
    t_de = float(torch.autograd.grad(sum(ts._constraint_losses(ts._batches()).values()), ts.eq_params["E"])[0])
    assert abs(j_de) > 1.0
    np.testing.assert_allclose(t_de, j_de, rtol=1e-4)


@pytest.mark.parametrize("save_bounds", [False, True])
def test_ten_stream_plain_kernels_match_the_pallas_segment(save_bounds):
    """The 3-D Hooke jet's 10 streams through 3 tanh layers of width 24 (a
    ragged last tile of the interpreted Pallas kernel): jet_mlp_fwd_plain's
    outputs and boundaries, jet_mlp_bwd_plain's input cotangents and
    jet_wgrad_plain's dW, db against the JAX segment's outputs and VJP."""
    streams, weights, biases, cot = _case(HOOKE_3D, 3)
    j_outs, j_gs, j_gw, j_gb = _jax_segment(HOOKE_3D, streams, weights, biases, cot, save_bounds)
    idx = tjet.build_index(HOOKE_3D)
    assert len(idx) == 10 and J.kernels_take(10, [24] * 4)
    ss, ws, bs, gs = ([torch.from_numpy(a) for a in arrs] for arrs in (streams, weights, biases, cot))
    outs, bounds = J.jet_mlp_fwd_plain(ss, ws, bs, idx, save_bounds=True)
    g_in, gzs = J.jet_mlp_bwd_plain(ss, bounds, ws, bs, gs, idx)
    dws, dbs = J.jet_wgrad_plain([ss] + [b.unbind(0) for b in bounds], gzs)
    for got, ref in zip([*outs, *g_in, *dws, *dbs], [*j_outs, *j_gs, *j_gw, *j_gb]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())

