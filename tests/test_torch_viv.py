"""The port's viv example (learnable equation parameters) against
paddlescience_tpu on the CPU: the RK4 data bitwise, three train steps of
the JAX example's solver and of the port's from the same weights and the
same k1, k2 (losses and k1, k2 within 1e-4 relative), and the parameters
carried through the state, a checkpoint and a resume.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlescience_tpu.autodiff import path as jpath
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import viv as tviv
from paddlescience_torch.utils import save_load
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_eq_params, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import viv as jviv  # noqa: E402  (the JAX example)

STEPS = 3


@pytest.fixture(autouse=True)
def _highest_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def test_the_data_are_the_jax_examples():
    for got, ref in zip(tviv.make_viv_data(), jviv.make_viv_data()):
        np.testing.assert_array_equal(got, ref)


def test_three_train_steps_match_jax_with_k1_k2(tmp_path):
    js = jviv.build_solver(epochs=1, iters_per_epoch=STEPS, output_dir=str(tmp_path))
    assert set(js.state["eq_params"]) == {"k1", "k2"}
    params0 = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    eq0 = {k: np.asarray(v) for k, v in js.state["eq_params"].items()}
    j_losses, j_k = [], []
    with jpath.override(jpath.CANDIDATES["jet"]):
        step_fn = js._build_train_step()
        host = {"Sup": jax.tree.map(jnp.asarray, next(js.constraint["Sup"].data_iter))}
        for _ in range(STEPS):
            js.state, logs = step_fn(js.state, host)
            j_losses.append([float(logs["loss"])])
            j_k.append([float(js.state["eq_params"]["k1"]), float(js.state["eq_params"]["k2"])])

    ts = tviv.build_solver(epochs=1, iters_per_epoch=STEPS, output_dir=None, device="cpu", deriv="jet")
    load_jax_params(ts.model, params0)
    load_jax_eq_params(ts.eq_params, eq0)
    assert ts.equation["VIV"].param("k1") is ts.eq_params["k1"]
    t_losses, t_k = [], []
    for _ in range(STEPS):
        t_losses.append([float(ts.train_step()["loss"])])
        t_k.append([float(ts.eq_params["k1"].detach()), float(ts.eq_params["k2"].detach())])
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    np.testing.assert_allclose(t_k, j_k, rtol=1e-4)
    assert t_k[-1][0] != tviv.K1_INIT and t_k[-1][1] != tviv.K2_INIT


def test_eq_params_ride_in_the_state_checkpoint_and_resume(tmp_path):
    """Two epochs of 2 steps straight through against one epoch, a
    resume from its ``latest`` checkpoint and the second epoch: k1, k2,
    the network and the optimizer's moments bitwise equal."""
    full = tviv.build_solver(epochs=2, iters_per_epoch=2, output_dir=str(tmp_path / "full"), device="cpu")
    full.train()
    half = tviv.build_solver(epochs=1, iters_per_epoch=2, output_dir=str(tmp_path / "half"), device="cpu")
    half.train()
    assert set(half.state["eq_params"]) == {"k1", "k2"}
    resumed = tviv.build_solver(epochs=2, iters_per_epoch=2, output_dir=str(tmp_path / "resumed"), device="cpu")
    state = save_load.load_checkpoint(os.path.join(str(tmp_path / "half"), "checkpoints", "latest"))
    metric = state.pop("_metric")
    resumed._load_state(state)
    resumed.last_epoch = int(metric["last_epoch"])
    resumed.train()
    a, b = full.state_dict(), resumed.state_dict()
    for k in ("k1", "k2"):
        assert torch.equal(a["eq_params"][k], b["eq_params"][k]), k
        assert float(a["eq_params"][k].detach()) != (tviv.K1_INIT if k == "k1" else tviv.K2_INIT)
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for i in a["opt_state"]:
        for k in a["opt_state"][i]:
            assert torch.equal(a["opt_state"][i][k], b["opt_state"][i][k]), (i, k)


@pytest.mark.parametrize("name", ["MSELoss", "IntegralLoss", "L2RelLoss"])
@pytest.mark.parametrize("weight", [2.5, {"f": 10.0}])
def test_static_loss_weights_match_jax(name, weight):
    """A loss's static weight (one number, or one per key: viv weights its
    residual f by 10) scales each key's reduced loss, as in JAX."""
    import jax.numpy as jnp

    import paddlescience_tpu as psci
    from paddlescience_torch.loss import losses as tlosses

    rng = np.random.default_rng(2)
    shape = (3, 5, 1) if name == "IntegralLoss" else (6, 1)
    lab_shape = (3, 1) if name == "IntegralLoss" else shape
    out = {k: rng.standard_normal(shape).astype(np.float32) for k in ("eta", "f")}
    if name == "IntegralLoss":
        out["area"] = np.full(shape, 0.2, np.float32)
    lab = {k: rng.standard_normal(lab_shape).astype(np.float32) for k in ("eta", "f")}
    ref = getattr(psci.loss, name)("sum", weight=weight)({k: jnp.asarray(v) for k, v in out.items()},
                                                         {k: jnp.asarray(v) for k, v in lab.items()})
    got = getattr(tlosses, name)("sum", weight=weight)({k: torch.from_numpy(v) for k, v in out.items()},
                                                        {k: torch.from_numpy(v) for k, v in lab.items()})
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)
