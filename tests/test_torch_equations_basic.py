"""The port's other ``equation/pde/basic.py`` equations against
paddlescience_tpu on the CPU (Poisson, Helmholtz, NavierStokes with string
coefficients, Biharmonic with a string load, Vibration with its learnable
parameters) and ``detach_keys``: residual values and parameter gradients
within 1e-5 relative, as ``test_torch_equations.py``.
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


def test_poisson_and_helmholtz():
    check(psci.equation.Poisson(3), teq.Poisson(3), [(XYZ, ("p",))], XYZ)
    check(psci.equation.Helmholtz(2, 3.0), teq.Helmholtz(2, 3.0), [(("x", "y"), ("u",))], ("x", "y"))


def test_navier_stokes_with_a_string_viscosity():
    """A bare identifier is the field out["nu"] (here an input column, as
    in the JAX package, which adds the symbol to the independent
    variables); a number string is that number."""
    keys = ("x", "y", "nu")
    check(psci.equation.NavierStokes("nu", "2.0", 2, False), teq.NavierStokes("nu", "2.0", 2, False),
          [(keys, ("u", "v", "p"))], keys)
    check(psci.equation.NavierStokes("1/50", 1.5, 2, True), teq.NavierStokes("1/50", 1.5, 2, True),
          [(("t", "x", "y"), ("u", "v", "p"))], ("t", "x", "y"))


def test_navier_stokes_raises_on_an_expression_string():
    """An expression of fields and coordinates is read without sympy (held
    against the JAX sympy form, with the product rule of a viscosity that
    names a coordinate); a form outside the reader's grammar still raises,
    naming the form."""
    keys = ("x", "y", "nu")
    check(psci.equation.NavierStokes("nu * 2", 1.0, 2, False), teq.NavierStokes("nu * 2", 1.0, 2, False),
          [(keys, ("u", "v", "p"))], keys)
    check(psci.equation.NavierStokes("nu * (1 + x**2)", "2 + 0*nu", 2, False),
          teq.NavierStokes("nu * (1 + x**2)", "2 + 0*nu", 2, False), [(keys, ("u", "v", "p"))], keys)
    with pytest.raises(NotImplementedError, match="Derivative"):
        teq.NavierStokes("Derivative(nu, x)", 1.0, 2, False)
    assert teq.NavierStokes("pi", 1.0, 2, False).nu == pytest.approx(np.pi)


def test_biharmonic_with_a_string_load():
    specs = [(("x",), ("u", "q"))]
    check(psci.equation.Biharmonic(1, "q", 0.5), teq.Biharmonic(1, "q", 0.5), specs, ("x",), deriv="jvp")


def test_vibration_with_its_learnable_parameters():
    """f = rho eta_tt + exp(k1) eta_t + exp(k2) eta; the JAX form reads k1,
    k2 from the solver's eq_params, the port's closure from the PDE."""
    j_eq, t_eq = psci.equation.Vibration(2.0, -1.0, 1.0), teq.Vibration(2.0, -1.0, 1.0)
    assert set(t_eq.learnable_parameters) == {"k1", "k2"}
    _, tgrad = check(j_eq, t_eq, [(("t_f",), ("eta",))], ("t_f",), extra={"k1": np.float32(-1.0),
                                                                          "k2": np.float32(1.0)})
    assert float(tgrad["eq.k1"]) != 0.0 and float(tgrad["eq.k2"]) != 0.0


# ---------------------------------------------------------------- detach --


@pytest.mark.parametrize("eq,keys,detach", [
    ("ns", ("x", "y"), ("u",)),
    ("ns", ("x", "y"), ("u__x",)),
    ("laplace", ("x", "y"), ("u__x__x",)),
])
def test_detach_keys_match_jax_and_change_the_gradient(eq, keys, detach):
    """With ``detach_keys`` the parameter gradients match the JAX sympy
    form's detach rewrite, and differ from the undetached ones."""
    make = {"ns": lambda m, d: m.NavierStokes(0.01, 1.0, 2, False, detach_keys=d),
            "laplace": lambda m, d: m.Laplace(2, detach_keys=d)}[eq]
    outs = ("u", "v", "p") if eq == "ns" else ("u",)
    jgrad, tgrad = check(make(psci.equation, detach), make(teq, detach), [(keys, outs)], keys)
    _, plain = check(make(psci.equation, None), make(teq, None), [(keys, outs)], keys)
    diff = max(float((tgrad[n] - plain[n]).abs().max()) for n in plain)
    assert diff > 1e-4 * max(float(g.abs().max()) for g in plain.values())
