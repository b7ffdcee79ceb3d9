"""The port's UNetEx and its examples against paddlescience_tpu on the CPU:
the network's outputs and parameter gradients (1e-5; an even grid and an
odd one, where the pooling drops an edge and the nearest resize is not a
plain doubling), the 2x2 max pool's gradient on windows of tied maxima
(equal: both send it to a window's first maximum in row-major order),
topopt's Binary_Acc and IoU (1e-6) and three steps of topopt (its random
D4 augmentation drawing from numpy's global generator, reseeded on each
side) and of deepcfd_unetex against the JAX solvers (losses 1e-4)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddlescience_tpu as psci
from _earthformer_parity import numpy_init, one_torch_thread, three_steps  # noqa: F401
from _graph_parity import grads_parity, reseeded_steps
from _operator_parity import close, highest_precision  # noqa: F401
from paddlescience_torch.arch.unetex import UNetEx
from paddlescience_torch.examples import deepcfd_unetex as tcfd
from paddlescience_torch.examples import topopt as ttop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import deepcfd_unetex as jcfd  # noqa: E402  (the JAX examples)
import topopt as jtop  # noqa: E402


@pytest.mark.parametrize("hw,final", [((16, 16), None), ((18, 14), "sigmoid")], ids=["even", "odd"])
def test_unetex_matches_jax(hw, final):
    kw = dict(in_channel=2, out_channel=2, kernel_size=3, filters=(4, 8), layers=2, final_activation=final)
    with numpy_init():
        jm = psci.arch.UNetEx("x", "y", **kw)
    tm = UNetEx("x", "y", **kw)
    x = np.random.default_rng(0).standard_normal((2, 2) + hw).astype(np.float32)
    out = grads_parity(jm, tm, lambda m: m({"x": jnp.asarray(x)}), lambda m: m({"x": torch.from_numpy(x)}))
    assert out["y"].shape == (2, 2) + hw


def test_max_pool_gradient_on_tied_maxima_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (2, 3, 8, 10))  # clipped densities: ties everywhere
    cot = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)

    def pool(v):  # the JAX UNetEx's pool, on NHWC
        return jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")

    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    out, vjp = jax.vjp(pool, xj)
    (want,) = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = F.max_pool2d(xt, 2, 2)
    (g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), xt)
    assert np.array_equal(got.detach().numpy(), np.asarray(out).transpose(0, 3, 1, 2))
    windows = x.reshape(2, 3, 4, 2, 5, 2)
    assert (windows == windows.max((3, 5), keepdims=True)).sum((3, 5)).max() > 1  # tied maxima are there
    assert np.array_equal(g.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


def test_topopt_metrics_match_jax(tmp_path):
    with numpy_init():
        js = jtop.build_solver(epochs=1, batch_size=8, n_samples=10, output_dir=str(tmp_path))
    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 1, (4, 1, 8, 8)).astype(np.float32)
    true = (rng.uniform(0, 1, (4, 1, 8, 8)) > 0.5).astype(np.float32)
    want = js.validator["topopt_val"].metric["metrics"]({"output": jnp.asarray(pred)}, {"output": jnp.asarray(true)})
    got = ttop.val_metric({"output": torch.from_numpy(pred)}, {"output": torch.from_numpy(true)})
    assert set(got) == set(want) == {"Binary_Acc", "IoU"}
    for k in want:
        close(got[k], np.asarray(want[k]), 1e-6)


def test_topopt_three_steps_match_jax(tmp_path):
    kw = dict(epochs=1, batch_size=8, n_samples=20)
    with numpy_init():
        js = jtop.build_solver(output_dir=str(tmp_path / "jax"), **kw)
    ts = ttop.build_solver(output_dir=None, device="cpu", **kw)
    assert np.array_equal(js.constraint["sup_constraint"].dataset.input["input"],
                          ts.constraint["sup_constraint"].dataset.input["input"])
    reseeded_steps(js, ts, seed=5)


def test_deepcfd_three_steps_match_jax(tmp_path):
    with numpy_init():
        js = jcfd.build_solver(epochs=1, output_dir=str(tmp_path / "jax"))
    ts = tcfd.build_solver(epochs=1, output_dir=None, device="cpu")
    assert np.array_equal(js.constraint["Sup"].dataset.label["output"], ts.constraint["Sup"].dataset.label["output"])
    three_steps(js, ts)
