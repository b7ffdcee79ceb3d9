"""PDE base class (counterpart of ``paddlescience_tpu/equation/pde/base.py``).

Holds ``equations: Dict[str, Callable]`` of python-closure residuals. The
JAX package writes most named PDEs in sympy form and lowers them; sympy is
not installed where the port runs, so the port writes each residual out by
hand, every term a derivative component of order <= 2 taken directly from
a network (the product rule applied by hand where a coefficient is a
field), so the fused jet serves them.

``detach_keys`` follows the JAX package's detach rewrite of a sympy form
(``paddlescience_tpu/equation/pde/base.py::_apply_detach``): each
occurrence of a function value or derivative whose key (``u``, ``u__x``,
``u__x__y``: the function's name, then the differentiation axes in sorted
order) is listed has its parameter gradient stopped (:meth:`PDE.detach`).
A derivative of a detached function stays attached unless its own key is
listed. Equations that are closures in the JAX package too (AllenCahn,
Helmholtz) ignore ``detach_keys``, as there.

Learnable equation parameters (inverse problems): :meth:`PDE.create_parameter`
registers a float32 scalar tensor; the residual closures read it from the
PDE (:meth:`PDE.param`), and the ``Solver`` moves it to its device and
optimizes it with the model.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from paddlescience_torch.autodiff.ad import jacobian, stop_gradient, unwrap
from paddlescience_torch.utils.symbolic import Expression, read_expression

__all__ = ["PDE", "derivative_key", "parse_coefficient"]

Coefficient = Union[float, str, Expression]

def derivative_key(name: str, axes: Sequence[str] = ()) -> str:
    """The JAX package's key of d^k name / d axes (``_cvt_to_key``): the
    name, then each axis after ``__``, in sorted order as sympy orders a
    derivative's variables."""
    return name + "".join(f"__{a}" for a in sorted(axes))


def parse_coefficient(value: Coefficient, what: str) -> Coefficient:
    """A coefficient given as a string, read as the JAX package's sympy
    parser reads it, without sympy (``utils/symbolic.py``): arithmetic of
    numbers (``"1/3"``, ``"2.5e-3"``, ``"pi"``) is that number; a bare
    identifier (``"nu"``) is a field ``out[name]`` (an input column, a model
    output or a learnable parameter), returned as the name; any other
    expression (``"nu * 2"``, ``"exp(k) / 2"``) is returned as an
    :class:`~paddlescience_torch.utils.symbolic.Expression` of such names,
    which :meth:`PDE.coefficient` evaluates on the tensors. A form outside
    the reader's grammar raises ``NotImplementedError`` naming it. Numbers
    pass through as floats."""
    if not isinstance(value, str):
        return float(value)
    expr = read_expression(value, what)
    if not expr.names:
        return expr.constant
    if isinstance(ast.parse(value.strip(), mode="eval").body, ast.Name):
        return expr.names[0]
    return expr


class PDE:
    """Base class for partial differential equations."""

    def __init__(self):
        self.equations: Dict[str, Callable] = {}
        self.learnable_parameters: Dict[str, torch.Tensor] = {}
        self.detach_keys: Optional[Tuple[str, ...]] = None

    def add_equation(self, name: str, equation: Callable) -> None:
        if not callable(equation):
            raise TypeError(f"equation '{name}' must be a python closure over the output dict")
        self.equations[name] = equation

    # -- learnable parameters --------------------------------------------------

    def create_parameter(self, name: str, init_value: float) -> str:
        """Register a learnable float32 scalar (an inverse problem's unknown);
        returns its name. Closures read it with :meth:`param`."""
        self.learnable_parameters[name] = torch.tensor(float(init_value), dtype=torch.float32, requires_grad=True)
        return name

    def param(self, name: str) -> torch.Tensor:
        """The current tensor of learnable parameter ``name`` (the solver
        replaces it by its copy on the solver's device)."""
        return self.learnable_parameters[name]

    # -- detach and field access -------------------------------------------------

    def detach(self, key: str, value):
        """``value`` with its parameter gradient stopped when ``key`` is in
        ``detach_keys`` (the JAX package's ``detach(...)`` of a sympy
        form), else ``value``."""
        if self.detach_keys and key in self.detach_keys:
            return stop_gradient(value)
        return value

    def d(self, out, name: str, *axes: str):
        """The component d^k out[name] / d axes (k <= 2 from the jet; the
        value itself with no axes), through :meth:`detach` under its key."""
        value = out[name]
        for a in axes:
            value = jacobian(value, out[a])
        return self.detach(derivative_key(name, axes), value)

    def coefficient(self, out, value: Coefficient):
        """A number; the field ``out[name]`` (never differentiated), through
        :meth:`detach` under its name; or an expression of such fields,
        each through :meth:`detach`."""
        if isinstance(value, Expression):
            return value({n: unwrap(self.detach(n, out[n])) for n in value.names})
        return self.detach(value, out[value]) if isinstance(value, str) else value

    def _coefficient_derivative(self, out, expr: Expression, axis: str):
        """d expr / d axis of a coefficient expression that names the
        coordinate ``axis`` (its other names held fixed): a forward-mode
        derivative of the pointwise expression along that column."""
        values = {n: unwrap(self.detach(n, out[n])) for n in expr.names}
        x = values.pop(axis)
        return torch.func.jvp(lambda v: expr({**values, axis: v}), (x,), (torch.ones_like(x),))[1]
