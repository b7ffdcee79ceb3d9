"""The parametric activations ``Stan`` and ``Swish`` of the port (learnable
``beta``) against paddlescience_tpu on the CPU: alone, in an MLP, a
ModifiedMLP and a PirateNet (forward, and derivatives up to order 2 on the
plain jet path, with ``beta`` carried by ``utils/jax_params.py``; the
comparison and its tolerances are ``_mlp_parity.py``'s), their jet rule
against autograd, and their staying off the fused kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _mlp_parity import WIDTH, check_against_jax, close, pair
from paddlescience_torch.arch import activation as tact
from paddlescience_torch.arch import mlp as tmlp
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.autodiff import path as tpath


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


CASES = {
    "mlp_stan": (psci.arch.MLP, tmlp.MLP, dict(num_layers=3, hidden_size=WIDTH, activation="stan")),
    "mlp_swish": (psci.arch.MLP, tmlp.MLP, dict(num_layers=3, hidden_size=WIDTH, activation="swish",
                                                 weight_norm=True)),
    "modified_mlp_stan": (psci.arch.ModifiedMLP, tmlp.ModifiedMLP,
                          dict(num_layers=2, hidden_size=WIDTH, activation="stan", weight_norm=True)),
    "piratenet_swish": (psci.arch.PirateNet, tmlp.PirateNet,
                        dict(num_blocks=1, hidden_size=WIDTH, activation="swish", fourier={"dim": WIDTH, "scale": 1.0})),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_derivatives_and_gradients_match_jax(case):
    check_against_jax(*pair(*CASES[case]))


@pytest.mark.parametrize("act", ["stan", "swish"])
def test_parametric_activation_jet_rule_is_autograd(act):
    """f, f', f'' of ``jet_derivs`` against torch.autograd at a nudged
    beta, in float64."""
    m = tact.get_activation(act)(4) if act == "stan" else tact.get_activation(act)(1.0)
    with torch.no_grad():
        m.beta.add_(0.3 * torch.randn(m.beta.shape, generator=torch.Generator().manual_seed(0)))
    m = m.double()
    x = torch.linspace(-3, 3, 64, dtype=torch.float64).reshape(16, 4).requires_grad_()
    f = m(x)
    f1 = torch.autograd.grad(f.sum(), x, create_graph=True)[0]
    f2 = torch.autograd.grad(f1.sum(), x)[0]
    got = m.jet_derivs(x)
    for a, b in zip(got, (f, f1, f2)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_parametric_activations_match_jax_and_stay_off_the_kernels():
    """Stan (beta per unit) and Swish (scalar beta) against JAX's on the
    same beta; a net with one has no fused segment on any kernel path,
    while a weight-normed tanh ModifiedMLP keeps its segments."""
    x = np.linspace(-2, 2, 32, dtype=np.float32).reshape(4, 8)
    js = psci.arch.activation.Stan(8)
    ts = tact.Stan(8)
    beta = np.linspace(0.5, 1.5, 8).astype(np.float32)
    with torch.no_grad():
        ts.beta.copy_(torch.from_numpy(beta))
    with js.bind({"beta": jnp.asarray(beta)}, {}):
        close(ts(torch.from_numpy(x)), js(jnp.asarray(x)), 1e-6)
    jw, tw = psci.arch.activation.Swish(0.7), tact.Swish(0.7)
    close(tw(torch.from_numpy(x)), jw(jnp.asarray(x)), 1e-6)
    assert dict(tw.named_parameters())["beta"].shape == ()
    for deriv in ("jet_pallas", "jet_pallas_full"):
        with tpath.override(tpath.CANDIDATES[deriv]):
            for act in ("stan", "swish"):
                for m in (tmlp.MLP(("x", "y"), ("u",), 2, 256, act, device="cpu"),
                          tmlp.ModifiedMLP(("x", "y"), ("u",), 2, 256, act, device="cpu"),
                          tmlp.PirateNet(("x", "y"), ("u",), 1, 256, act, fourier={"dim": 256, "scale": 1.0},
                                         device="cpu")):
                    assert not m.jet_pallas_eligible() and m.jet_segment_lengths() == [], (deriv, act, type(m))
            wn = tmlp.ModifiedMLP(("x", "y"), ("u",), 2, 256, weight_norm=True, device="cpu")
            assert wn.jet_pallas_eligible() and wn.jet_segment_lengths()
            skip = tmlp.ModifiedMLP(("x", "y"), ("u",), 2, 256, skip_connection=True, device="cpu")
            assert not skip.jet_pallas_eligible() and skip.jet_segment_lengths() == []
    assert tjet.act_of(tact.Stan(3)) is None and tjet.act_of(tact.Swish()) is None
