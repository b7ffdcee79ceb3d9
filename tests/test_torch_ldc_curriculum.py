"""The port's LDC Re-curriculum (``examples/ldc_curriculum.py``) and what it
needs, against paddlescience_tpu on the CPU: ``loss_granularity="key"``,
the recipes' numbers, a two-stage curriculum of the plain recipe with the
solver state carried across stages, and the first stage of the sota
recipe (the set-up and the comparison are ``_ldc_parity.py``'s).
``ExponentialDecay`` with warmup and the PirateNet recipe's first stage are
held in ``test_torch_ldc_warmup.py``, the cavity generator and the Ghia
tables in ``test_torch_ldc_reference.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import paddlescience_tpu as psci
from _ldc_parity import NAMES, close, curriculum_parity, fields, jax_cfg, jldc, small_cfg
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import ldc_curriculum as tldc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = {"re3200_piratenet": "ldc_2d_Re3200_piratenet.yaml", "re3200_sota": "ldc_2d_Re3200_sota.yaml",
        "re1000_plain": "ldc_2d_Re1000_plain.yaml"}


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


# ------------------------------------------------------------ recipes --


@pytest.mark.parametrize("name", list(tldc.RECIPES))
def test_recipe_defaults_are_the_yaml_numbers(name):
    with open(os.path.join(ROOT, "examples", "conf", YAML[name])) as f:
        y = yaml.safe_load(f)
    cfg = tldc.RECIPES[name]()
    jcfg = jax_cfg(cfg, cfg["Re"], cfg["epochs"])
    for key in ("seed", "log_freq", "Re", "epochs", "MODEL"):
        assert jcfg[key] == y[key], key
    assert jcfg["EVAL"]["batch_size"] == y["EVAL"]["batch_size"]
    for key in ("iters_per_epoch", "eval_during_train", "eval_freq", "lr_scheduler", "batch_size", "grad_norm"):
        assert jcfg["TRAIN"][key] == y["TRAIN"][key], key


def test_key_granularity_names_order_and_sums(tmp_path, monkeypatch):
    """The five per-key losses in JAX's order (the JAX recipe's stage
    solver names them so too; their values are held to JAX's at every step
    of the curricula below); the constraint granularity sums them; any
    other value raises JAX's error."""
    monkeypatch.setattr(jldc, "_DATA", str(tmp_path))
    fields(tmp_path, [100])
    cfg = small_cfg("re1000_plain", tmp_path, (100,), (1,))
    jcfg = jax_cfg(cfg, (100,), (1,))
    jm = jldc.make_model(jcfg)
    js = jldc.build_stage_solver(jcfg, jm, psci.optimizer.Adam(1e-3)(jm), None, 100.0, 1, str(tmp_path / "jax"))
    tm = tldc.make_model(cfg, "cpu")
    ts = tldc.build_stage_solver(cfg, tm, None, None, 100.0, 1, None, "cpu")
    assert js._loss_names() == ts._loss_names() == NAMES
    batches = ts._batches()
    t_losses = ts._constraint_losses(batches)
    assert list(t_losses) == NAMES
    ts.loss_granularity = "constraint"
    summed = ts._constraint_losses(batches)
    assert list(summed) == ts._loss_names() == ["PDE", "BC"]
    close(summed["BC"], t_losses["BC.u"] + t_losses["BC.v"], 1e-6)
    close(summed["PDE"], sum(t_losses[n] for n in NAMES[:3]), 1e-6)
    for solver_cls, model, kw in ((psci.solver.Solver, jm, {}), (tldc.Solver, tm, {"device": "cpu"})):
        with pytest.raises(ValueError, match="loss_granularity must be 'constraint' or 'key', got loss"):
            solver_cls(model, {}, None, loss_granularity="loss", **kw)


@pytest.mark.parametrize("name", ["re1000_plain"])
def test_two_stage_curriculum_matches_jax(name, tmp_path, monkeypatch):
    """Two stages (Re 100, 400) x 3 steps of the plain recipe, the state
    carried, held as ``curriculum_parity`` says (losses 1e-4, GradNorm
    weights 1e-4, parameters 1e-2 lr, the step). Its schedule is cut to a
    one-epoch warmup and a decay every 2 steps (its own: none and 2000), so
    that the lr clock carried into the second stage shows in its losses."""
    curriculum_parity(name, tmp_path, monkeypatch, (100, 400), warmup_epoch=1, decay_steps=2)


@pytest.mark.parametrize("name", ["re3200_sota"])
def test_first_stage_matches_jax(name, tmp_path, monkeypatch):
    """The first stage (Re 100, 3 steps) of the sota recipe, at its own
    GradNorm ``init_weights`` [10, 1, 1, 100, 100] (which hold only in
    JAX's loss order) and inside its 5-epoch warmup, held as
    ``curriculum_parity`` says."""
    results = curriculum_parity(name, tmp_path, monkeypatch, (100,))
    assert results[0]["weights"] != [10.0, 1.0, 1.0, 100.0, 100.0]  # refreshed


def test_state_carries_the_generator_and_the_schedule_clock(tmp_path):
    """``next.state = solver.state``: the next stage draws where the last
    one stopped and reads the carried step (the warmup's lr)."""
    fields(tmp_path, [100, 400])
    cfg = small_cfg("re1000_plain", tmp_path, (100, 400), (1, 1))
    model = tldc.make_model(cfg, "cpu")
    opt, gn = tldc.make_training(cfg, model)
    a = tldc.build_stage_solver(cfg, model, opt, gn, 100.0, 1, None, "cpu")
    a.train_steps(2)
    b = tldc.build_stage_solver(cfg, model, opt, gn, 400.0, 1, None, "cpu")
    b.state = a.state
    assert b.step == 2 and float(b._step_t) == 2.0
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    assert torch.equal(b.agg_state["weight"], a.agg_state["weight"])
    assert float(b.train_step()["lr"]) == float(torch.tensor(opt.lr_fn(2)))


def test_evaluate_scores_the_last_stage_checkpoint(tmp_path):
    """``evaluate`` at the last Re: a checkpoint of the curriculum's last
    stage scores what that stage's eval did; a fresh model scores else."""
    fields(tmp_path, [100, 400])
    cfg = small_cfg("re1000_plain", tmp_path, (100, 400), (1, 1))
    results = tldc.train_curriculum(cfg, output_dir=str(tmp_path / "run"), device="cpu")
    latest = str(tmp_path / "run" / "Re_400" / "checkpoints" / "latest")
    metric = tldc.evaluate(cfg, latest, output_dir=None, device="cpu")
    assert metric == pytest.approx(results[-1]["metric"], rel=1e-6)
    assert tldc.evaluate(cfg, None, output_dir=None, device="cpu") != pytest.approx(metric, rel=1e-3)
