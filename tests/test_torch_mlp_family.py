"""The rest of the port's MLP family against paddlescience_tpu on the CPU:
``weight_norm`` of ModifiedMLP and PirateNet, ``skip_connection`` of
ModifiedMLP, and explicit ``input_dim``/``output_dim`` (forward, and
derivatives up to order 2 on the plain jet path; a weight-normed net also
on the fused gated segment), with parameters carried by
``utils/jax_params.py``. The comparison and its tolerances are
``_mlp_parity.py``'s; the parametric activations are held in
``test_torch_parametric_activations.py``.
"""

import jax
import pytest

import paddlescience_tpu as psci
from _mlp_parity import WIDTH, check_against_jax, pair
from paddlescience_torch.arch import mlp as tmlp
from paddlescience_torch.autodiff import path as tpath


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


CASES = {
    "modified_mlp_weight_norm": (psci.arch.ModifiedMLP, tmlp.ModifiedMLP,
                                 dict(num_layers=3, hidden_size=WIDTH, weight_norm=True)),
    "modified_mlp_skip": (psci.arch.ModifiedMLP, tmlp.ModifiedMLP,
                          dict(num_layers=4, hidden_size=WIDTH, skip_connection=True,
                               random_weight={"mean": 1.0, "std": 0.1})),
    "modified_mlp_dims": (psci.arch.ModifiedMLP, tmlp.ModifiedMLP,
                          dict(num_layers=2, hidden_size=WIDTH, input_dim=2, output_dim=2, weight_norm=True,
                               fourier={"dim": 8, "scale": 1.0})),
    "piratenet_weight_norm": (psci.arch.PirateNet, tmlp.PirateNet,
                              dict(num_blocks=2, hidden_size=WIDTH, weight_norm=True,
                                   fourier={"dim": WIDTH, "scale": 1.0})),
    "piratenet_dims": (psci.arch.PirateNet, tmlp.PirateNet,
                       dict(num_blocks=1, hidden_size=WIDTH, input_dim=2, output_dim=2,
                            fourier={"dim": WIDTH, "scale": 1.0}, random_weight={"mean": 1.0, "std": 0.1})),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_derivatives_and_gradients_match_jax(case):
    check_against_jax(*pair(*CASES[case]))


def test_weight_normed_gated_segment_matches_jax():
    """A weight-normed ModifiedMLP on the fused gated segment (its plain
    version on the CPU): the effective weights formed before the segment,
    residual derivatives and gradients as on the plain jet path of JAX."""
    jm, params, rest, tm = pair(*CASES["modified_mlp_weight_norm"])
    with tpath.override(tpath.CANDIDATES["jet_pallas_full"]):
        assert tm.jet_segment_lengths() == [3]
    check_against_jax(jm, params, rest, tm, names=["u_xx", "v_xy", "u_y"], port_path="jet_pallas_full",
                      forward=False)


def test_gated_nets_reject_list_widths_and_mismatched_embeddings():
    for cls, kw in ((tmlp.ModifiedMLP, dict(num_layers=None)), (tmlp.PirateNet, dict(num_blocks=1))):
        with pytest.raises(ValueError, match="hidden_size should be int"):
            cls(("x",), ("u",), hidden_size=[8, 8], device="cpu", **kw)
    with pytest.raises(ValueError, match="must equal the embedded width 3"):
        tmlp.PirateNet(("x", "y"), ("u",), 1, 8, input_dim=3, device="cpu")
