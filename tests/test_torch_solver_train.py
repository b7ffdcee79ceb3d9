"""The port's ``Solver.train()`` by epochs and chunks, its checkpoints and
resume, against paddlescience_tpu on the CPU.

``train()`` runs epochs of K-step chunks with eval and ``best_model`` as
the JAX solver's ``_train_fused_static``: both start from the same weights
(the JAX example's MLP cut to 2 x 32, Fourier 32) on the same fixed batch
(a ``sample_fn`` that ignores its key or generator), with GradNorm
refreshed every 2 steps (so a chunk of 4 steps refreshes once, at its
start, in both). Tolerances are the three-step test's
(``tests/test_torch_allen_cahn.py``): logged losses 1e-4 relative,
parameters within 1e-2 lr of each other; the eval metric 1e-4.

On the CPU a chunk is K eager steps (the CUDA graph needs the card; its
tests are in ``test_torch_cuda_graph.py``), so chunked training equals
``train_steps`` bitwise, and a run resumed from ``latest`` equals an
uninterrupted one bitwise.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import one_torch_thread  # noqa: F401
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.data import DeviceSampledDataset as JDeviceSampledDataset
from paddlescience_tpu.loss import mtl as jmtl
from paddlescience_tpu.solver import solver as jsolver_mod
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.data import DeviceSampledDataset
from paddlescience_torch.examples import allen_cahn as tallen_cahn
from paddlescience_torch.optimizer import Adam as TAdam
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay as TExponentialDecay
from paddlescience_torch.utils import save_load
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import allen_cahn as jallen_cahn  # noqa: E402  (the JAX example)

CUT = dict(num_layers=2, hidden_size=32, fourier_dim=32)
N_PDE, LR, UPDATE_FREQ, EPOCHS, ITERS = 256, 1e-3, 2, 2, 4


@pytest.fixture(autouse=True)
def _float32_and_paths(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PSCI_AUTOTUNE", "0")
    monkeypatch.delenv("PSCI_FUSE_CAP", raising=False)
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tallen_cahn.get_reference_solution(str(tmp_path_factory.mktemp("ref") / "allen_cahn_ref.npz"))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 1.0, (N_PDE, 1)), axis=0).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (N_PDE, 1)).astype(np.float32)
    return t, x


def _port_solver(tmp_path=None, **kw):
    """The port's example solver, small, GradNorm every UPDATE_FREQ steps."""
    args = dict(epochs=EPOCHS, iters_per_epoch=ITERS, batch_size=N_PDE, ic_points=64, update_freq=UPDATE_FREQ,
                log_freq=1, eval_freq=1, deriv="jet_pallas_full", device="cpu", with_validator=False,
                output_dir=None if tmp_path is None else str(tmp_path), **CUT)
    args.update(kw)
    return tallen_cahn.build_solver(**args)


# ---------------------------------------------------------- against JAX --


@pytest.mark.parametrize("k", [2, 4])
def test_train_by_epochs_matches_jax_solver(monkeypatch, tmp_path, reference, k):
    """2 epochs x 4 iterations in chunks of k, eval each epoch: the logged
    losses and learning rates, the final parameters, best_metric and the
    checkpoint directories with their metric.json."""
    mlp = psci.arch.MLP
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, num_layers, hidden_size, fourier=None, **rest: mlp(
        i, o, num_layers=CUT["num_layers"], hidden_size=CUT["hidden_size"],
        fourier={**fourier, "dim": CUT["fourier_dim"]}, **rest))
    monkeypatch.setattr(jallen_cahn, "get_reference_solution", lambda: reference)
    monkeypatch.setattr(tallen_cahn, "get_reference_solution", lambda path=None: reference)
    monkeypatch.setattr(jmtl, "GradNorm", lambda model, n, update_freq, momentum, _g=jmtl.GradNorm: _g(
        model, n, UPDATE_FREQ, momentum))
    js, _ = jallen_cahn.build_solver(epochs=EPOCHS, iters_per_epoch=ITERS, batch_size=N_PDE, eval_freq=1,
                                     output_dir=str(tmp_path / "jax"))
    js.log_freq = 1
    ts = _port_solver(tmp_path / "port", with_validator=True, ic_points=512)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    t, x = _batch()
    jfixed = ({"t": jnp.asarray(t), "x": jnp.asarray(x)}, {"allen_cahn": jnp.zeros((N_PDE, 1))}, {})
    js.constraint["PDE"].dataset = JDeviceSampledDataset(lambda key: jfixed)
    tfixed = ({"t": torch.from_numpy(t), "x": torch.from_numpy(x)}, {"allen_cahn": torch.zeros(N_PDE, 1)}, {})
    ts.constraint["PDE"].dataset = DeviceSampledDataset(lambda gen: tfixed)

    j_logs = []
    monkeypatch.setattr(jsolver_mod.logger, "scalar", lambda d, step: j_logs.append((step, dict(d))))
    with jpath.override(jpath.CANDIDATES["jet_pallas_full"]):
        js.train(num_fused_steps=k)
    t_logs = ts.train(num_fused_steps=k)

    assert [s for s, _ in j_logs] == [e["step"] for e in t_logs] == list(range(k, EPOCHS * ITERS + 1, k))
    keys = ("loss", "loss/PDE", "loss/IC", "lr")
    np.testing.assert_allclose([[e[n] for n in keys] for e in t_logs],
                               [[float(d[n]) for n in keys] for _, d in j_logs], rtol=1e-4)
    assert [s for s, _ in ts.loss_history] == [e["step"] for e in t_logs]
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    diffs = np.concatenate([np.abs(p.detach().numpy() - j_params[n]).ravel() for n, p in ts.model.named_parameters()])
    assert diffs.max() <= 1e-2 * LR
    assert ts.last_epoch == js.last_epoch == EPOCHS and ts.step == EPOCHS * ITERS
    assert ts.best_metric["epoch"] == js.best_metric["epoch"]
    np.testing.assert_allclose(ts.best_metric["metric"], js.best_metric["metric"], rtol=1e-4)

    j_dir, t_dir = tmp_path / "jax" / "checkpoints", tmp_path / "port" / "checkpoints"
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    for prefix in os.listdir(j_dir):
        j_json, t_json = j_dir / prefix / "metric.json", t_dir / prefix / "metric.json"
        assert j_json.exists() == t_json.exists()
        assert (t_dir / prefix / save_load.STATE_FILE).exists()
        if j_json.exists():
            jm, tm = json.loads(j_json.read_text()), json.loads(t_json.read_text())
            assert set(tm) == set(jm) and all(tm[n] == jm[n] for n in jm if n != "metric")
            np.testing.assert_allclose(tm["metric"], jm["metric"], rtol=1e-4)


@pytest.mark.parametrize("ipe,cap", [(1000, None), (1000, "100"), (7, None), (12, "5"), (1, None)])
def test_auto_fuse_steps_match_jax(monkeypatch, ipe, cap):
    if cap is not None:
        monkeypatch.setenv("PSCI_FUSE_CAP", cap)
    ts = _port_solver(iters_per_epoch=ipe)
    js = jsolver_mod.Solver.__new__(jsolver_mod.Solver)
    js.iters_per_epoch = ipe
    assert ts._auto_fuse_steps() == jsolver_mod.Solver._auto_fuse_steps(js)
    assert ts._all_constraints_static()


def test_tensor_schedule_matches_optax_float32():
    """The schedule's tensor form on a float32 step counter against the
    JAX schedule at an int32 step (optax's float32 arithmetic)."""
    kw = dict(epochs=200, iters_per_epoch=1000, learning_rate=1e-3, gamma=0.9, decay_steps=2000)
    jf, tf = psci.optimizer.lr_scheduler.ExponentialDecay(**kw)(), TExponentialDecay(**kw)()
    for step in (0, 1, 7, 1999, 2000, 123457, 199999):
        got = tf(torch.tensor(float(step)))
        assert got.dtype == torch.float32 and got.shape == ()
        ref = jf(jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_adam_state_exists_from_step_0_and_updates_as_torchs():
    """The state made when the optimizer is built is what torch makes at
    its first step: three steps give bitwise torch's own Adam's."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    ref = torch.nn.Linear(4, 3)
    ref.load_state_dict(lin.state_dict())
    opt = TAdam(1e-2)(lin)
    assert opt.lr_t is None and set(opt.torch_opt.state[lin.weight]) == {"step", "exp_avg", "exp_avg_sq"}
    torch_opt = torch.optim.Adam(ref.parameters(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for i in range(3):
        g = torch.randn(3, 4)
        for m in (lin, ref):
            m.weight.grad, m.bias.grad = g.clone(), g[:, 0].clone()
        opt.step(i)
        torch_opt.step()
        assert torch.equal(lin.weight, ref.weight) and torch.equal(lin.bias, ref.bias)
    assert float(opt.torch_opt.state[lin.weight]["step"]) == 3.0
    opt.zero_grad()
    assert lin.weight.grad is not None and not lin.weight.grad.any()


# ------------------------------------------------ chunks, checkpoints --


def _state(solver):
    """Every tensor of the training state, on the host."""
    sd = solver.state_dict()
    out = {f"params.{n}": v for n, v in sd["params"].items()}
    out.update({f"opt.{i}.{k}": v for i, st in sd["opt_state"].items() for k, v in st.items()})
    out.update({f"agg.{k}": v for k, v in sd["agg_state"].items()})
    out["generator"] = sd["generator"]
    return {k: v.detach().clone() for k, v in out.items()}, sd["step"]


def _assert_same_state(a, b):
    (sa, step_a), (sb, step_b) = _state(a), _state(b)
    assert step_a == step_b and set(sa) == set(sb)
    diff = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert not diff, f"differ: {diff}"


@pytest.mark.parametrize("k", [1, 2, 4])
def test_chunked_training_equals_step_by_step(k):
    """train() in chunks of k (GradNorm refreshed every 4 steps, at chunk
    starts) gives bitwise the parameters, Adam state, GradNorm weights and
    generator state of train_steps over the same steps."""
    chunked = _port_solver(update_freq=4)
    stepped = _port_solver(update_freq=4)
    logged = chunked.train(num_fused_steps=k)
    stepped.train_steps(EPOCHS * ITERS)
    _assert_same_state(chunked, stepped)
    assert chunked.last_epoch == EPOCHS and len(logged) == EPOCHS * ITERS // k
    assert not chunked.graph_stats  # no graph on the CPU
    assert float(chunked.agg_state["weight"][0]) != 1.0  # the refresh ran


def test_train_refuses_a_chunk_that_does_not_divide_the_epoch():
    with pytest.raises(ValueError, match="must divide"):
        _port_solver().train(num_fused_steps=3)
    with pytest.raises(ValueError, match="no optimizer"):
        tallen_cahn.build_solver(device="cpu", with_validator=False, output_dir=None, **CUT).__class__(
            torch.nn.Linear(1, 1), device="cpu").train()


def test_resume_from_latest_equals_an_uninterrupted_run(tmp_path):
    """One epoch, saved; a new solver from ``checkpoints/latest`` trains the
    second: bitwise the state (parameters, Adam, GradNorm weights,
    generator), the step and last_epoch of one two-epoch run.
    ``load_pretrain`` restores the parameters alone."""
    first = _port_solver(tmp_path / "first", epochs=1)
    first.train(num_fused_steps=2)
    latest = tmp_path / "first" / "checkpoints" / "latest"
    assert sorted(os.listdir(latest)) == ["metric.json", save_load.STATE_FILE]
    assert json.loads((latest / "metric.json").read_text()) == {"metric": float("inf"), "epoch": 0, "last_epoch": 1}
    resumed = _port_solver(tmp_path / "resumed", checkpoint_path=str(latest))
    assert resumed.last_epoch == 1 and resumed.step == ITERS
    resumed.train(num_fused_steps=2)
    whole = _port_solver(tmp_path / "whole")
    whole.train(num_fused_steps=2)
    _assert_same_state(resumed, whole)
    assert resumed.last_epoch == whole.last_epoch == EPOCHS

    fresh = _port_solver()
    pre = _port_solver()
    pre.load_pretrain(str(latest))
    for (n, p), q in zip(pre.model.named_parameters(), first.model.parameters()):
        assert torch.equal(p, q), n
    (s_pre, step_pre), (s_fresh, step_fresh) = _state(pre), _state(fresh)
    assert step_pre == step_fresh == 0 and pre.last_epoch == 0
    assert all(torch.equal(s_pre[k], s_fresh[k]) for k in s_pre if not k.startswith("params."))
    with pytest.raises(ValueError, match="do not match"):
        tallen_cahn.build_solver(device="cpu", with_validator=False, output_dir=None, num_layers=3,
                                 hidden_size=32, fourier_dim=32).load_pretrain(str(latest))
    with pytest.raises(FileNotFoundError):
        _port_solver(checkpoint_path=str(tmp_path / "nowhere"))


def test_best_model_and_epoch_checkpoints(tmp_path, reference, monkeypatch):
    """eval every epoch keeps best_model (metric, epoch, last_epoch),
    save_freq writes epoch_<k> without a metric, latest carries the best
    metric; a solver resumed from best_model takes its last_epoch."""
    monkeypatch.setattr(tallen_cahn, "get_reference_solution", lambda path=None: reference)
    s = _port_solver(tmp_path, with_validator=True, ic_points=512)
    s.save_freq = 1
    s.train(num_fused_steps=4)
    ckpt = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["best_model", "epoch_1", "epoch_2", "latest"]
    assert not (ckpt / "epoch_1" / "metric.json").exists()
    best = json.loads((ckpt / "best_model" / "metric.json").read_text())
    latest = json.loads((ckpt / "latest" / "metric.json").read_text())
    assert best == {**s.best_metric, "last_epoch": s.best_metric["epoch"]}
    assert latest == {**s.best_metric, "last_epoch": EPOCHS}
    again = _port_solver(checkpoint_path=str(ckpt / "best_model"))
    assert again.best_metric == s.best_metric and again.last_epoch == s.best_metric["epoch"]
    save_load.save_checkpoint({"params": {}}, None)  # no output_dir: nothing written
