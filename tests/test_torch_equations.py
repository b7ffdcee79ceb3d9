"""The port's ``LinearElasticity`` against paddlescience_tpu on the CPU:
residual values and parameter gradients in 3-D (the Lame parameters as
numbers, from E and nu, and as fields of a third network) and in 2-D with
``time`` and string fields, through networks with the same weights on the
same seeded points (``_equation_parity.py``: a JAX ``ModelList`` of small
MLPs carried into the port's). The parameter gradient is that of the sum
of squared residuals. Tolerance: 1e-5 relative (float32; the sympy form
and the closure sum their terms in other orders), measured against the
largest magnitude.
"""

import jax
import numpy as np
import pytest

import paddlescience_tpu as psci
from paddlescience_torch import equation as teq
from paddlescience_torch.autodiff import path as tpath

from _equation_parity import check


@pytest.fixture(autouse=True)
def _highest_precision():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


XYZ = ("x", "y", "z")
DISP3 = ("u", "v", "w")
STRESS3 = ("sigma_xx", "sigma_yy", "sigma_zz", "sigma_xy", "sigma_xz", "sigma_yz")


@pytest.mark.parametrize("deriv", ["jet", "jet_pallas_full"])
@pytest.mark.parametrize("case", ["lame", "E_nu", "fields"])
def test_linear_elasticity_3d(case, deriv):
    """The nine residuals of the mixed form plus the three tractions, with
    numbers (bracket's lambda_/mu, control_arm's E/nu) and with the Lame
    parameters as fields of a third network (the inverse problem)."""
    specs = [(XYZ, DISP3), (XYZ, STRESS3)]
    kw = {"lame": dict(lambda_=1.5, mu=1.0, nu=0.3), "E_nu": dict(E=1.0, nu=0.3),
          "fields": dict(lambda_="lambda_", mu="mu")}[case]
    if case == "fields":
        specs.append((XYZ, ("lambda_", "mu")))
    check(psci.equation.LinearElasticity(dim=3, **kw), teq.LinearElasticity(dim=3, **kw), specs, XYZ,
          normals=True, deriv=deriv)


@pytest.mark.parametrize("time", [False, True])
def test_linear_elasticity_2d_with_time_and_a_string_rho(time):
    specs = [(("t", "x", "y") if time else ("x", "y"), ("u", "v", "sigma_xx", "sigma_yy", "sigma_xy", "rho"))]
    keys = ("t", "x", "y") if time else ("x", "y")
    kw = dict(E="E", nu=0.25, rho="rho", dim=2, time=time)
    check(psci.equation.LinearElasticity(**kw), teq.LinearElasticity(**kw), specs, keys, normals=True,
          extra={"E": np.float32(2.5)})
