"""Shared set-up of the LDC curriculum parity tests
(``test_torch_ldc_curriculum.py``, ``test_torch_ldc_stages.py``): small
recipes, the JAX config for a port config, small reference fields, an
injected PDE batch, and :func:`curriculum_parity`, which runs a curriculum
on both packages from the same parameters and compares them.

The curricula run at small sizes (width 16, one block or two layers, 64
PDE points, 4 x 8 wall points, 3 steps a stage, GradNorm every 2 steps so
that each stage refreshes at its steps 0 and 2). Both packages get the same
initial parameters (``load_jax_params``), the same PDE batch (made with
numpy from a seed and injected through a ``DeviceSampledDataset`` whose
``sample_fn`` ignores its key or generator) and the same small reference
fields, written to a temporary directory that the JAX recipe's ``_DATA``
is pointed at. The JAX side builds each stage with the recipe's own
``build_stage_solver``, takes the previous stage's ``solver.state`` and
steps its jitted train step, refreshing GradNorm as its per-step
``train`` loop does; the port runs ``train_curriculum`` with one step a
chunk.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.data import DeviceSampledDataset as JDeviceSampledDataset
from paddlescience_tpu.utils.config import Config
from paddlescience_torch.data import DeviceSampledDataset
from paddlescience_torch.data.dataset import ldc_reference as tref
from paddlescience_torch.examples import ldc_curriculum as tldc
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import _ldc_common as jldc  # noqa: E402  (the JAX recipes)

STEPS, N_PDE, N_BC, WIDTH, UPDATE_FREQ, LR = 3, 64, 8, 16, 2, 1e-3
NAMES = ["PDE.continuity", "PDE.momentum_x", "PDE.momentum_y", "BC.u", "BC.v"]
SMALL = {"re3200_piratenet": dict(num_blocks=1, fourier={"dim": WIDTH, "scale": 1.0}),
         "re3200_sota": dict(num_layers=2, fourier={"dim": WIDTH, "scale": 1.0}),
         "re1000_plain": dict(num_layers=2)}


def close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def jax_cfg(cfg, Re, epochs):
    """The JAX recipe's config (the YAML layout) for the port's ``cfg``."""
    model = {"arch": cfg["arch"], "input_keys": list(cfg["input_keys"]), "output_keys": list(cfg["output_keys"]),
             "hidden_size": cfg["hidden_size"], "activation": cfg["activation"]}
    model.update({k: cfg[k] for k in ("num_blocks", "num_layers") if k in cfg})
    if cfg["fourier"]:
        model["fourier"] = dict(cfg["fourier"])
    if cfg["random_weight"]:
        model["random_weight"] = dict(cfg["random_weight"])
    return Config.wrap({
        "seed": cfg["seed"], "output_dir": None, "log_freq": cfg["log_freq"], "Re": list(Re), "epochs": list(epochs),
        "MODEL": model,
        "TRAIN": {"iters_per_epoch": cfg["iters_per_epoch"], "eval_during_train": cfg["eval_during_train"],
                  "eval_freq": cfg["eval_freq"],
                  "lr_scheduler": {"learning_rate": cfg["learning_rate"], "gamma": cfg["gamma"],
                                   "decay_steps": cfg["decay_steps"], "warmup_epoch": cfg["warmup_epoch"]},
                  "batch_size": {"pde": cfg["bs_pde"], "bc": cfg["bs_bc"]},
                  "grad_norm": {"update_freq": cfg["update_freq"], "momentum": cfg["momentum"],
                                "init_weights": list(cfg["init_weights"])}},
        "EVAL": {"batch_size": cfg["eval_batch"]}})


def fields(tmp_path, Re_list, n=9):
    """Small smooth reference fields, written where both packages read them."""
    x = np.linspace(0, 1, n).astype(np.float32)
    X, Y = np.meshgrid(x, x, indexing="ij")
    for i, Re in enumerate(Re_list):
        u = (np.sin(np.pi * X) * Y ** (2 + i)).astype(np.float32)
        v = (-0.3 * np.sin(2 * np.pi * Y) * X * (1 - X)).astype(np.float32)
        np.savez(tref.reference_path(Re, cache_dir=str(tmp_path)), u=u, v=v, x=x, y=x)


def _pde_batch(seed):
    xy = np.random.default_rng(seed).uniform(0, 1, (N_PDE, 2)).astype(np.float32)
    return xy[:, 0:1], xy[:, 1:2]


def _inject(monkeypatch, x, y):
    zeros = np.zeros((N_PDE, 1), np.float32)
    jbatch = ({"x": jnp.asarray(x), "y": jnp.asarray(y)}, {k: jnp.asarray(zeros) for k in
                                                          ("continuity", "momentum_x", "momentum_y")}, {})
    tbatch = ({"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
              {k: torch.from_numpy(zeros) for k in ("continuity", "momentum_x", "momentum_y")}, {})
    monkeypatch.setattr(jldc, "DeviceSampledDataset", lambda fn: JDeviceSampledDataset(lambda key: jbatch))
    monkeypatch.setattr(tldc, "DeviceSampledDataset", lambda fn: DeviceSampledDataset(lambda gen: tbatch))


def small_cfg(name, tmp_path, Re, epochs, **overrides):
    return tldc.RECIPES[name](**{**dict(hidden_size=WIDTH, Re=Re, epochs=epochs, iters_per_epoch=STEPS,
                                        bs_pde=N_PDE, bs_bc=N_BC, update_freq=UPDATE_FREQ, log_freq=1, eval_batch=64,
                                        reference_dir=str(tmp_path), **SMALL[name]), **overrides})


def curriculum_parity(name, tmp_path, monkeypatch, Re, **overrides):
    """The curriculum of recipe ``name`` over the stages ``Re`` (one epoch of
    3 steps each, ``overrides`` on the small recipe) on both packages, the
    state carried: every step's total and per-key losses within 1e-4, the
    GradNorm weights at each stage's end (refreshed at its steps 0 and 2)
    within 1e-4, the parameters after each stage within 1e-2 lr, and the
    global step carried. Returns the port's per-stage results."""
    epochs = (1,) * len(Re)
    x, y = _pde_batch(1)
    _inject(monkeypatch, x, y)
    monkeypatch.setattr(jldc, "_DATA", str(tmp_path))
    fields(tmp_path, Re)
    cfg = small_cfg(name, tmp_path, Re, epochs, **overrides)
    jcfg = jax_cfg(cfg, Re, epochs)

    # -- JAX: the recipe's model, optimizer and GradNorm, one stage solver per Re, state carried
    psci.utils.set_random_seed(int(jcfg.seed))
    jm = jldc.make_model(jcfg)
    params0 = jax.tree.map(np.asarray, jm.param_tree())
    buffers0 = jax.tree.map(np.asarray, jm.buffer_tree())
    lr = psci.optimizer.lr_scheduler.ExponentialDecay(
        epochs=sum(epochs), iters_per_epoch=STEPS, learning_rate=cfg["learning_rate"], gamma=cfg["gamma"],
        decay_steps=cfg["decay_steps"], warmup_epoch=cfg["warmup_epoch"])()
    jopt = psci.optimizer.Adam(lr)(jm)
    jgn = psci.loss.mtl.GradNorm(jm, 5, UPDATE_FREQ, cfg["momentum"], init_weights=list(cfg["init_weights"]))
    carry, j_losses, j_stages = None, [], []
    keys = ["loss"] + [f"loss/{n}" for n in NAMES]
    for Re_i, ep in zip(Re, epochs):
        js = jldc.build_stage_solver(jcfg, jm, jopt, jgn, float(Re_i), ep, str(tmp_path / f"jax{Re_i}"))
        if carry is not None:
            js.state = carry
        step_fn = js._build_train_step()
        for i in range(STEPS):
            host = {"BC": jax.tree.map(jnp.asarray, next(js.constraint["BC"].data_iter))}
            js._maybe_refresh_agg_weights(host, i)
            js.state, logs = step_fn(js.state, host)
            j_losses.append([float(logs[k]) for k in keys])
        carry = js.state
        j_stages.append((np.asarray(carry["agg_state"]["weight"]), flatten_tree(jax.tree.map(np.asarray,
                                                                                              carry["params"])),
                         int(carry["step"])))

    # -- port: train_curriculum from the same parameters, each stage's parameters read after its train()
    make_model, build = tldc.make_model, tldc.build_stage_solver
    t_params = []

    def seeded_model(c, device=None):
        m = make_model(c, device)
        load_jax_params(m, params0, buffers0)
        return m

    def recording_build(*args, **kwargs):
        s = build(*args, **kwargs)
        train = s.train

        def train_and_record(*a, **k):
            logs = train(*a, **k)
            t_params.append({n: p.detach().clone() for n, p in s.model.named_parameters()})
            return logs

        s.train = train_and_record
        return s

    monkeypatch.setattr(tldc, "make_model", seeded_model)
    monkeypatch.setattr(tldc, "build_stage_solver", recording_build)
    results = tldc.train_curriculum(cfg, output_dir=None, device="cpu", num_fused_steps=1)
    assert all(list(entry) == keys + ["lr", "step"] for r in results for entry in r["logs"])
    t_losses = [[entry[k] for k in keys] for r in results for entry in r["logs"]]
    np.testing.assert_allclose(np.array(t_losses), np.array(j_losses), rtol=1e-4)
    assert len(t_params) == len(results) == len(j_stages)
    for r, tp, (jw, jp, jstep) in zip(results, t_params, j_stages):
        assert r["step"] == jstep
        close(np.asarray(r["weights"], np.float32), jw, 1e-4)
        assert set(tp) == set(jp)
        for n, p in tp.items():
            assert np.abs(p.numpy() - jp[n]).max() <= 1e-2 * LR, n
    assert [r["Re"] for r in results] == list(Re) and all(np.isfinite(r["metric"]) for r in results)
    assert [r["step"] for r in results] == [STEPS * (i + 1) for i in range(len(Re))]
    return results
