"""``ExponentialDecay`` with warmup on the port against paddlescience_tpu on
the CPU, and the first stage (Re 100, 3 steps) of the PirateNet LDC
recipe, which runs inside its 5-epoch warmup at its own GradNorm
``init_weights`` [10, 1, 1, 100, 100] (which hold only in JAX's loss
order): the set-up and the comparison are ``_ldc_parity.py``'s (losses
1e-4, GradNorm weights after the refreshes at steps 0 and 2 within 1e-4,
parameters 1e-2 lr, the step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _ldc_parity import curriculum_parity
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay as TExponentialDecay


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


# ----------------------------------------------------------- schedule --


@pytest.mark.parametrize("by_epoch", [False, True])
@pytest.mark.parametrize("warmup_epoch", [0, 2, 9])
def test_exponential_decay_with_warmup_matches_jax_on_every_step(warmup_epoch, by_epoch):
    """Every step of a 4 x 5 schedule (a warmup longer than the run is cut
    to it): the float32 tensor form a captured step reads within 1e-7 of
    the JAX schedule (also float32; bitwise equal on the CPU), and the
    float form the CPU solver uses, evaluated in float64, within 2e-7 (the
    JAX schedule's float32 rounding and pow: up to 1.33e-7 here)."""
    kw = dict(epochs=4, iters_per_epoch=5, learning_rate=1e-3, gamma=0.9, decay_steps=3,
              warmup_epoch=warmup_epoch, warmup_start_lr=1e-5, by_epoch=by_epoch)
    jf = psci.optimizer.lr_scheduler.ExponentialDecay(**kw)()
    tf = TExponentialDecay(**kw)()
    steps = np.arange(0, 21)
    ref = np.array([float(jf(jnp.asarray(s, jnp.int32))) for s in steps])
    np.testing.assert_allclose(tf(torch.tensor(steps, dtype=torch.float32)).numpy(), ref, rtol=1e-7, atol=0)
    np.testing.assert_allclose([tf(int(s)) for s in steps], ref, rtol=2e-7, atol=0)
    assert tf.by_epoch == by_epoch


def test_exponential_decay_without_warmup_keeps_its_numbers():
    """The callers from before the warmup (no warmup, by step) get the
    same numbers as the standalone schedule did: lr0 * gamma ** (t / ds)."""
    tf = TExponentialDecay(3, 5, 1e-3, 0.9, 4)()
    for step in (0, 1, 4, 7, 14):
        assert tf(step) == 1e-3 * 0.9 ** (step / 4)
    t = torch.arange(15, dtype=torch.float32)
    assert torch.equal(tf(t), 1e-3 * torch.pow(0.9, t / 4))


# ------------------------------------------------------------ recipe --


@pytest.mark.parametrize("name", ["re3200_piratenet"])
def test_first_stage_matches_jax(name, tmp_path, monkeypatch):
    results = curriculum_parity(name, tmp_path, monkeypatch, (100,))
    assert results[0]["weights"] != [10.0, 1.0, 1.0, 100.0, 100.0]  # refreshed
