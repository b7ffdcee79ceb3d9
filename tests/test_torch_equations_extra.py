"""The port's ``equation/pde/extra.py`` (NLSMB, HeatExchanger, Hooke)
against paddlescience_tpu on the CPU: residual values and parameter
gradients (of the sum of squared residuals) within 1e-5 relative, through
networks with the same weights on the same seeded points
(``_equation_parity.py``). Hooke with a field ``E`` differentiates
products of the field and the strains: the port applies the product rule
by hand, from first and second derivative components of the networks.
"""

import jax
import numpy as np
import pytest

import paddlescience_tpu as psci
from paddlescience_torch import equation as teq
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.ops import jet_mlp

from _equation_parity import check, run_both

XYZ = ("x", "y", "z")
NLSMB_OUT = ("Eu", "Ev", "pu", "pv", "eta")


@pytest.fixture(autouse=True)
def _highest_precision():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


@pytest.mark.parametrize("time", [True, False])
def test_nlsmb(time):
    keys = ("t", "x") if time else ("x",)
    kw = dict(alpha_1=0.5, alpha_2=-1.0, omega_0=0.25, time=time)
    check(psci.equation.NLSMB(**kw), teq.NLSMB(**kw), [(keys, NLSMB_OUT)], keys)


def test_heat_exchanger():
    specs = [(("x", "t", "qm_h"), ("T_h",)), (("x", "t", "qm_c"), ("T_c",)), (("x", "t"), ("T_w",))]
    args = (1.0, 0.8, 1.5, 1.2, 2.0, 3.0)
    check(psci.equation.HeatExchanger(*args), teq.HeatExchanger(*args), specs, ("x", "t", "qm_h", "qm_c"))


@pytest.mark.parametrize("deriv", ["jet", "jet_pallas_full"])
def test_hooke_with_a_field_E(deriv):
    """E and P from a second network: every hooke_* residual carries E's
    first derivatives (the product rule)."""
    specs = [(XYZ, ("u", "v", "w")), (XYZ, ("E", "P"))]
    kw = dict(E="E", nu=0.45, P="P", dim=3)
    check(psci.equation.Hooke(**kw), teq.Hooke(**kw), specs, XYZ, normals=True, deriv=deriv)


def test_hooke_with_a_learnable_E_and_a_field_nu_in_2d():
    """E = ("learnable", 2.0) registers the parameter E (its gradient held
    too); a field nu brings its derivatives; the 2-D traction keeps
    t_zz n_z^2, as the JAX form does."""
    specs = [(("x", "y"), ("u", "v", "nu"))]
    kw = dict(E=("learnable", 2.0), nu="nu", P=1.064, dim=2)
    j_eq, t_eq = psci.equation.Hooke(**kw), teq.Hooke(**kw)
    assert set(t_eq.learnable_parameters) == {"E"}
    _, tgrad = check(j_eq, t_eq, specs, ("x", "y"), normals=True, extra={"E": np.float32(2.0)})
    assert float(tgrad["eq.E"]) != 0.0


def test_hooke_3d_ten_streams_are_taken_and_seventeen_refused():
    """All six second derivatives of a 3-D displacement: 10 jet streams,
    which the MLP kernels take (up to 16 streams; the segment's plain
    versions here); 17 they refuse."""
    specs = [(XYZ, ("u", "v", "w"))]
    kw = dict(E=9.0, nu=0.45, P=1.064, dim=3)
    jres, _, tres, _ = run_both(psci.equation.Hooke(**kw), teq.Hooke(**kw), specs, XYZ, normals=True,
                                deriv="jet_pallas_full", names=["hooke_x"])
    np.testing.assert_allclose(tres["hooke_x"].detach().numpy(), np.asarray(jres["hooke_x"]), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jres["hooke_x"])).max()))
    assert jet_mlp.kernels_take(10, (3, 12, 12)) and not jet_mlp.kernels_take(17, (3, 12, 12))
