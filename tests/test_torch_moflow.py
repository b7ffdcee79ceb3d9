"""The port's MoFlow (``paddlescience_torch/arch/moflow_net.py``,
``MOlFLOWDataset``, ``examples/moflow_qm9.py`` and
``examples/moflow_optimize.py``) against paddlescience_tpu on the CPU:
the flow at the example's widths on 8 synthetic molecules, latent and
log-det within 1e-5 of their largest magnitude and parameter gradients
within 1e-4 of the whole gradient's; the reverse of the same latents
within 1e-5, and the round trip within 1e-4; the dataset's arrays equal
to JAX's, a .csv refused by both; three moflow_qm9 steps (the JAX
example's own loop, its jitted steps recorded) with JAX's latent draw
passed in, losses within 1e-4 and the parameters after them within 1e-4
of the largest; and moflow_optimize's three stages at 3 steps each, the
flow's and the head's losses within 1e-4 and the mean property gain
within 1e-4 of the property. TF32 off, JAX at "highest"; JAX modules
built from numpy draws, JAX functions compiled at XLA's lowest
optimisation level (``_earthformer_parity.py``)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import fast_call, numpy_init, one_torch_thread  # noqa: F401
from _graph_parity import capture_arch
from _misc_parity import params_close, run_jax
from _operator_parity import close, highest_precision  # noqa: F401
from _radar_parity import parity
from paddlescience_tpu.data.dataset.domain_dataset import MOlFLOWDataset as JMolDataset
from paddlescience_torch.arch.moflow_net import MoFlowNet, MoFlowProp
from paddlescience_torch.data import build_dataset
from paddlescience_torch.examples import moflow_optimize as topt
from paddlescience_torch.examples import moflow_qm9 as tqm9
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import moflow_optimize as jopt  # noqa: E402  (the JAX examples)
import moflow_qm9 as jqm9  # noqa: E402

T = torch.from_numpy
EXAMPLE = dict(b_n_type=4, a_n_node=9, a_n_type=5, b_hidden=64, a_hidden=64, b_n_blocks=2, a_n_blocks=2)


@pytest.fixture(scope="module")
def flow_pair():
    with numpy_init():
        jm = psci.arch.MoFlowNet(**EXAMPLE)
    tm = MoFlowNet(**EXAMPLE, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    return jm, tm


def _molecules(n=8):
    ds = JMolDataset(num_samples=n)
    return {k: ds.input[k] for k in ("nodes", "edges")}


def test_moflow_matches_jax(flow_pair):
    jm, tm = flow_pair
    mol = _molecules()
    out = parity(jm, tm, lambda m: m({k: jnp.asarray(v) for k, v in mol.items()}),
                 lambda m: m({k: T(v) for k, v in mol.items()}), load=False)
    assert out["output"].shape == (8, 9 * 5 + 9 * 4 * 9) and out["sum_log_det"].shape == (8,)


def test_moflow_reverse_matches_jax(flow_pair):
    jm, tm = flow_pair
    mol = _molecules()
    z = np.random.default_rng(0).standard_normal((8, tm.latent_dim)).astype(np.float32) * 0.5
    j_nodes, j_edges = (np.asarray(a) for a in fast_call(lambda v: jm.reverse(v), jnp.asarray(z)))
    with torch.no_grad():
        t_nodes, t_edges = tm.reverse(T(z))
        close(t_nodes, j_nodes, 1e-5)
        close(t_edges, j_edges, 1e-5)
        back, _ = tm.reverse(tm({k: T(v) for k, v in mol.items()})["output"])
    assert float(torch.abs(back - T(mol["nodes"])).max()) < 1e-4


def test_molflow_dataset_matches_jax(tmp_path):
    j = JMolDataset(num_samples=16, label_keys=("n",))
    t = build_dataset({"name": "MOlFLOWDataset", "num_samples": 16, "label_keys": ("n",)})
    for k in ("nodes", "edges"):
        np.testing.assert_array_equal(t.input[k], j.input[k])
    np.testing.assert_array_equal(t.label["n"], j.label["n"])
    csv = tmp_path / "qm9.csv"
    csv.write_text("smiles\nC\n")
    for make in (lambda: JMolDataset(file_path=str(csv)),
                 lambda: build_dataset({"name": "MOlFLOWDataset", "file_path": str(csv)})):
        with pytest.raises(NotImplementedError, match="rdkit"):
            make()


def test_moflow_qm9_three_steps_match_jax(monkeypatch):
    cap = {}
    capture_arch(monkeypatch, psci.arch, "MoFlowNet", cap)
    records = run_jax(jqm9.main, 3)
    z = np.array(jax.random.normal(jax.random.PRNGKey(0), (4, 9 * 5 + 9 * 4 * 9)))  # the JAX example's draw
    fit = tqm9.MoFlowFit(device="cpu")
    load_jax_params(fit.model, cap["params"])
    losses = []
    monkeypatch.setattr(fit.loop, "run", lambda k, graphed=True, real=fit.loop.run: losses.append(
        real(k, graphed)) or losses[-1])
    tqm9.main(3, fit=fit, z=T(z))
    steps = [r for r in records if r[0] == "step"]
    np.testing.assert_allclose([float(l["loss"]) for l in losses], [float(r[1][2]) for r in steps], rtol=1e-4)
    params_close(steps[-1][1][0], fit.model)


def test_moflow_optimize_stages_match_jax(monkeypatch):
    flow, prop = {}, {}
    capture_arch(monkeypatch, psci.arch, "MoFlowNet", flow)
    capture_arch(monkeypatch, psci.arch, "MoFlowProp", prop)
    metric = []
    records = run_jax(lambda: metric.append(jopt.run(train_steps=3, fit_steps=3, opt_steps=3)))
    fit = tqm9.MoFlowFit(device="cpu")
    load_jax_params(fit.model, flow["params"])
    tprop = MoFlowProp(fit.model, hidden_size=(64,))
    load_jax_params(tprop.hidden, prop["params"]["hidden"])  # the head's own parameters (the flow is fit's)
    load_jax_params(tprop.out, prop["params"]["out"])
    got = topt.run(train_steps=3, fit_steps=3, opt_steps=3, fit=fit, prop=tprop)
    nll = [float(r[1][2]) for r in records if r[0] == "nll_step"]
    mse = [float(r[1][2]) for r in records if r[0] == "fit_step"]
    assert len(nll) == len(mse) == 3
    np.testing.assert_allclose([got["nll"], got["mse"]], [nll[-1], mse[-1]], rtol=1e-4)
    assert abs(got["metric"] - metric[0]) <= 1e-4 * abs(got["before"])
