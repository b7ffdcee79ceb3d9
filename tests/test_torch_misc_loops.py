"""The port's recurrent hand-loop examples against paddlescience_tpu on
the CPU: phylstm_seismic types 2 and 3 (hidden 8, T 8) and
phycrnet_burgers at 16 x 16. Each JAX example runs itself with ``jax.jit``
wrapped to compile at XLA's lowest optimisation level and record every
step's outputs (``_misc_parity.py``), its network built from numpy draws;
the port's loop starts from the same parameters: losses within 1e-4, the
parameters after three steps within 1e-4 of the largest magnitude.
tempogan_lite's loop is in ``test_torch_tempogan.py`` beside its nets."""

import os
import sys

import numpy as np
import pytest

import paddlescience_tpu as psci
from _earthformer_parity import one_torch_thread  # noqa: F401
from _graph_parity import capture_arch
from _misc_parity import params_close, run_jax
from _operator_parity import highest_precision  # noqa: F401
from paddlescience_torch.examples import phycrnet_burgers as tcrn
from paddlescience_torch.examples import phylstm_seismic as tlstm
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import phycrnet_burgers as jcrn  # noqa: E402  (the JAX examples)
import phylstm_seismic as jlstm  # noqa: E402


def _hand_steps(records, fit, name="step", steps=3):
    """The port's ``steps`` steps from the JAX loop's initial parameters
    (already loaded), each step's loss against the recorded one (output 2
    of the JAX step); returns the recorded steps' outputs."""
    got = [fit.train_steps(1)["loss"] for _ in range(steps)]
    steps_j = [out for n, out in records if n == name][:steps]
    assert len(steps_j) == steps
    np.testing.assert_allclose(got, [float(out[2]) for out in steps_j], rtol=1e-4)
    return steps_j


@pytest.mark.parametrize("model_type", [2, 3])
def test_phylstm_three_steps_match_jax(model_type, monkeypatch):
    for mod in (jlstm, tlstm):  # the example's T = 32 cut to 8
        monkeypatch.setattr(mod, "T", 8)
    ag, eta, phi = jlstm._synthetic_records()
    for a, b in zip((ag, eta, phi), tlstm.synthetic_records()):
        assert np.array_equal(a, b)
    cap = {}
    capture_arch(monkeypatch, psci.arch, "DeepPhyLSTM", cap, hidden_size=8)
    records = run_jax(jlstm.main, 3, model_type=model_type)
    fit = tlstm.PhyLSTMFit(model_type, hidden_size=8, device="cpu")
    load_jax_params(fit.model, cap["params"])
    steps_j = _hand_steps(records, fit)
    # type 3 reads the restoring force g only as phi g, and phi maps a constant to 0: g's head bias is free
    free = {"lstm_model.head.bias": (slice(2, 3), 2 * 3 * 1e-3)} if model_type == 3 else None
    params_close(steps_j[-1][0], fit.model, free=free)


def test_phycrnet_three_steps_match_jax(monkeypatch):
    for mod in (jcrn, tcrn):  # the example's 32 x 32 grid cut (the 8x pixel shuffle still fills it)
        monkeypatch.setattr(mod, "H", 16)
        monkeypatch.setattr(mod, "W", 16)
    assert np.array_equal(jcrn._initial_field(), tcrn.initial_field())
    cap = {}
    capture_arch(monkeypatch, psci.arch, "PhyCRNet", cap)
    records = run_jax(jcrn.main, 3)
    fit = tcrn.PhyCRNetFit(device="cpu")
    load_jax_params(fit.model, cap["params"])
    steps_j = _hand_steps(records, fit)
    params_close(steps_j[-1][0], fit.model)
