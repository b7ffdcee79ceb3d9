"""The Allen-Cahn recipe family on the port (the ``loss``/``aggregator``
knobs, ``RECIPES``) and the NTK aggregator, against paddlescience_tpu on the
CPU.

NTK's refresh and total, GradNorm's ``init_weights`` (and its length
check), each of the six variants built with the knobs of the JAX example's
table and ``conf/allen_cahn*.yaml``, and three train steps of
``default_ntk`` and ``sota`` against the JAX example's
``build_solver(aggregator="ntk", ...)``: both cut to 2 layers x 32
(Fourier 32) by wrapping the JAX arch classes, NTK refreshed every 2 steps
(at steps 0 and 2; the JAX example hard-codes 1000), the same parameters
(``load_jax_params``) and the same PDE batch (numpy from a seed, injected
through a ``DeviceSampledDataset`` that ignores its key or generator).
Both sides run their default derivative path (the plain jet path at these
widths); the JAX side steps its jitted train step and refreshes before
each step as its per-step ``train`` loop does.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import paddlescience_tpu as psci
from paddlescience_tpu.data import DeviceSampledDataset as JDeviceSampledDataset
from paddlescience_tpu.loss import mtl as jmtl
from paddlescience_torch.arch.mlp import MLP, ModifiedMLP, PirateNet
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.data import DeviceSampledDataset
from paddlescience_torch.examples import allen_cahn as tallen_cahn
from paddlescience_torch.loss import mtl as tmtl
from paddlescience_torch.loss.losses import CausalMSELoss, MSELoss
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import allen_cahn as jallen_cahn  # noqa: E402  (the JAX example)

CUT = dict(num_layers=2, hidden_size=32, fourier_dim=32)
N_PDE, LR, UPDATE_FREQ, STEPS = 256, 1e-3, 2, 3
YAML = {"default": "allen_cahn.yaml", "causal": "allen_cahn_causal.yaml", "plain": "allen_cahn_plain.yaml",
        "default_ntk": "allen_cahn_ntk.yaml", "sota": "allen_cahn_sota.yaml",
        "piratenet": "allen_cahn_piratenet.yaml"}


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


@pytest.fixture(scope="module")
def reference():
    """The reference (t, x, u) as far as the solvers built here read it,
    with no validator: its time range, its grid and its first row, the
    initial condition x^2 cos(pi x) (bitwise the row the ETDRK4 solve
    starts from; the solve itself takes seconds and is not needed)."""
    x = np.linspace(-1, 1, 512, endpoint=False)
    u0 = (x**2) * np.cos(np.pi * x)
    return np.array([0.0, 1.0], np.float32), x.astype(np.float32), u0.astype(np.float32)[None, :]


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


# -------------------------------------------------------- aggregators --


def test_ntk_refresh_and_aggregate_match_jax():
    """w_i = sum |g| / |g_i| (a zero norm clamped to 1e-12: a weight of
    1e12 scale), no EMA; the weighted total. Relative 1e-6, float32."""
    norms = np.array([3.0e-2, 4.5, 0.0, 250.0], np.float32)
    losses = np.array([0.7, 0.2, 1.3, 1e-3], np.float32)
    jn, tn = jmtl.NTK(None, 4, 2), tmtl.NTK(None, 4, 2)
    assert tn.needs_grad_norms and tn.update_freq == 2
    ts0 = tn.init_state(torch.device("cpu"))
    _close(ts0["weight"], jn.init_state()["weight"], 0)
    js = jn.update_weights(jn.init_state(), jnp.asarray(norms))
    ts = tn.update_weights(ts0, torch.from_numpy(norms))
    assert ts["weight"].dtype == torch.float32
    _close(ts["weight"], js["weight"], 1e-6)
    js2 = jn.update_weights(js, jnp.asarray(norms[::-1].copy()))  # no memory of the last weights
    ts2 = tn.update_weights(ts, torch.from_numpy(norms[::-1].copy()))
    _close(ts2["weight"], js2["weight"], 1e-6)
    jt, _ = jn.aggregate([jnp.asarray(v) for v in losses], js, 1)
    tt, _ = tn.aggregate([torch.tensor(v) for v in losses], ts)
    _close(tt, jt, 1e-6)


def test_gradnorm_init_weights_match_jax():
    init = [10, 1, 1, 100, 100]
    norms = np.array([2.0, 0.5, 3.0, 1e-3, 4.0], np.float32)
    jg, tg = jmtl.GradNorm(None, 5, 1000, 0.9, init_weights=init), tmtl.GradNorm(None, 5, 1000, 0.9, init_weights=init)
    js, ts = jg.init_state(), tg.init_state(torch.device("cpu"))
    assert ts["weight"].dtype == torch.float32
    _close(ts["weight"], js["weight"], 0)
    _close(tg.update_weights(ts, torch.from_numpy(norms))["weight"],
           jg.update_weights(js, jnp.asarray(norms))["weight"], 1e-6)
    _close(tmtl.GradNorm(None, 3).init_state(torch.device("cpu"))["weight"], jmtl.GradNorm(None, 3).init_state()["weight"], 0)
    for cls in (jmtl.GradNorm, tmtl.GradNorm):
        with pytest.raises(ValueError) as err:
            cls(None, 4, 1000, 0.9, init_weights=init)
        assert str(err.value) == "Length of init_weights(5) should be equal to num_losses(4)."


# ------------------------------------------------------------ variants --


@pytest.mark.parametrize("name", list(tallen_cahn.RECIPES))
def test_variants_carry_the_jax_knobs_and_build(name, reference, monkeypatch):
    """Each variant's knobs are its YAML's (arch, Fourier scale, RWF, loss,
    aggregator, epochs, batch, decay); built small, the port's solver has
    the JAX example's net class, PDE loss and aggregator."""
    with open(os.path.join(ROOT, "examples", "conf", YAML[name])) as f:
        y = yaml.safe_load(f)
    kw = tallen_cahn.recipe(name)
    model_cfg, train_cfg = y["MODEL"], y["TRAIN"]
    assert kw["arch"] == model_cfg["arch"]
    assert kw.get("fourier_scale") == model_cfg.get("fourier_scale")
    assert kw.get("rwf_mean") == model_cfg.get("rwf_mean")
    assert kw.get("piratenet_blocks", 3) == model_cfg.get("piratenet_blocks", 3)
    assert (kw["loss"], kw["aggregator"]) == (train_cfg.get("loss", "causal"), train_cfg.get("aggregator", "gradnorm"))
    for key in ("epochs", "batch_size", "decay_steps"):
        assert kw.get(key, {"epochs": 200, "batch_size": 4096, "decay_steps": 2000}[key]) == train_cfg[key], key

    monkeypatch.setattr(tallen_cahn, "get_reference_solution", lambda path=None: reference)
    ts = tallen_cahn.build_solver(**tallen_cahn.recipe(name, epochs=1, iters_per_epoch=2, batch_size=64, num_layers=1,
                                                      hidden_size=16, fourier_dim=16, piratenet_blocks=1,
                                                      device="cpu", with_validator=False, output_dir=None))
    arch = {"mlp": MLP, "modified_mlp": ModifiedMLP, "piratenet": PirateNet}[kw["arch"]]
    assert type(ts.model) is arch
    gated = kw["arch"] != "mlp"
    assert ts.model.fourier["scale"] == kw.get("fourier_scale", 2.0 if gated else 1.0)
    assert isinstance(ts.constraint["PDE"].loss, CausalMSELoss if kw["loss"] == "causal" else MSELoss)
    agg = {"gradnorm": tmtl.GradNorm, "ntk": tmtl.NTK, "sum": tmtl.Sum}[kw["aggregator"]]
    assert type(ts.loss_aggregator) is agg
    logs = ts.train_step()
    assert np.isfinite(float(logs["loss"]))
    with pytest.raises(ValueError, match="variant 'sotaa' not found"):
        tallen_cahn.recipe("sotaa")
    for bad in (dict(loss="l1"), dict(aggregator="pcgrad")):
        with pytest.raises(ValueError, match="not found"):
            tallen_cahn.build_solver(device="cpu", with_validator=False, **bad)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 1.0, (N_PDE, 1)), axis=0).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (N_PDE, 1)).astype(np.float32)
    return t, x


@pytest.mark.parametrize("name", ["default_ntk", "sota"])
def test_three_ntk_steps_match_jax_example(name, reference, monkeypatch):
    """Three steps: the total and per-constraint losses within 1e-4
    relative, the NTK weights after each refresh (steps 0 and 2) within
    1e-4 of their size, the parameters within 1e-2 lr."""
    kw = tallen_cahn.recipe(name)
    cls_name = "ModifiedMLP" if kw["arch"] == "modified_mlp" else "MLP"
    jcls = getattr(psci.arch, cls_name)
    monkeypatch.setattr(psci.arch, cls_name, lambda i, o, num_layers, hidden_size, fourier=None, **rest: jcls(
        i, o, num_layers=CUT["num_layers"], hidden_size=CUT["hidden_size"],
        fourier={**fourier, "dim": CUT["fourier_dim"]}, **rest))
    monkeypatch.setattr(jallen_cahn, "get_reference_solution", lambda: reference)
    monkeypatch.setattr(tallen_cahn, "get_reference_solution", lambda path=None: reference)
    monkeypatch.setattr(jmtl, "NTK", lambda model, n, update_freq, _n=jmtl.NTK: _n(model, n, UPDATE_FREQ))
    jkw = {k: kw[k] for k in ("arch", "fourier_scale", "rwf_mean", "loss", "aggregator", "decay_steps") if k in kw}
    js, _ = jallen_cahn.build_solver(epochs=1, iters_per_epoch=STEPS, batch_size=N_PDE, with_validator=False,
                                     eval_during_train=False, output_dir=None, **jkw)
    ts = tallen_cahn.build_solver(**tallen_cahn.recipe(
        name, epochs=1, iters_per_epoch=STEPS, batch_size=N_PDE, update_freq=UPDATE_FREQ, device="cpu",
        with_validator=False, eval_during_train=False, output_dir=None, **CUT))
    assert type(js.loss_aggregator).__name__ == type(ts.loss_aggregator).__name__ == "NTK"
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    t, x = _batch()
    jfixed = ({"t": jnp.asarray(t), "x": jnp.asarray(x)}, {"allen_cahn": jnp.zeros((N_PDE, 1))}, {})
    js.constraint["PDE"].dataset = JDeviceSampledDataset(lambda key: jfixed)
    tfixed = ({"t": torch.from_numpy(t), "x": torch.from_numpy(x)}, {"allen_cahn": torch.zeros(N_PDE, 1)}, {})
    ts.constraint["PDE"].dataset = DeviceSampledDataset(lambda gen: tfixed)

    keys = ("loss", "loss/PDE", "loss/IC")
    step_fn = js._build_train_step()
    j_losses, t_losses, j_w, t_w = [], [], [], []
    for i in range(STEPS):
        host = {"IC": jax.tree.map(jnp.asarray, next(js.constraint["IC"].data_iter))}
        js._maybe_refresh_agg_weights(host, i)
        j_w.append(np.asarray(js.state["agg_state"]["weight"]))
        js.state, logs = step_fn(js.state, host)
        j_losses.append([float(logs[k]) for k in keys])
        logs = ts.train_step()
        t_w.append(ts.agg_state["weight"].clone())
        t_losses.append([float(logs[k]) for k in keys])
    np.testing.assert_allclose(np.array(t_losses), np.array(j_losses), rtol=1e-4)
    for i in (0, 2):  # the refresh steps
        assert not np.allclose(j_w[i], 1.0)
        _close(t_w[i], j_w[i], 1e-4)
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    for n, p in ts.model.named_parameters():
        assert np.abs(p.detach().numpy() - j_params[n]).max() <= 1e-2 * LR, n
