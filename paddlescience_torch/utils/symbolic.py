"""A small reader of expression strings, without sympy.

The JAX package reads string coefficients (``NavierStokes("nu * 2", ...)``)
with sympy's parser and lambdifies sympy labels and weights of constraints.
sympy is not installed where the port runs, so the port reads the string
(for a sympy object, ``str(expr)``, which sympy prints in this grammar)
with Python's ``ast`` and evaluates the tree on tensors or numpy arrays:

* numbers, ``pi`` and ``E``;
* ``+ - * / **`` and unary minus;
* the functions ``sin cos tan exp log sqrt tanh Abs``;
* names: fields, coordinates and learnable parameters, read from a dict.

Any other form (``Derivative(u(x), x)``, an unknown function, a
comparison) raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import ast
import math
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["Expression", "read_expression", "FUNCTIONS"]

CONSTANTS = {"pi": math.pi, "E": math.e}
FUNCTIONS = ("sin", "cos", "tan", "exp", "log", "sqrt", "tanh", "Abs")
_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b, ast.Mult: lambda a, b: a * b,
           ast.Div: lambda a, b: a / b, ast.Pow: lambda a, b: a**b}
_LIBS: Dict[str, Dict[str, Callable]] = {
    "torch": {"sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "exp": torch.exp, "log": torch.log,
              "sqrt": torch.sqrt, "tanh": torch.tanh, "Abs": torch.abs},
    "numpy": {"sin": np.sin, "cos": np.cos, "tan": np.tan, "exp": np.exp, "log": np.log, "sqrt": np.sqrt,
              "tanh": np.tanh, "Abs": np.abs},
}


def _as_float(v):
    return float(v) if isinstance(v, (int, float)) else v


class Expression:
    """A parsed expression: ``names`` are its free names (in order of first
    appearance), ``expr(values, lib="torch")`` evaluates it with
    ``values[name]`` for each name and ``lib``'s functions (``"torch"`` or
    ``"numpy"``). A number stays a Python float, so an expression of
    numbers alone is that number (:attr:`constant`)."""

    def __init__(self, text: str, tree: ast.AST, names: Tuple[str, ...]):
        self.text = text
        self._tree = tree
        self.names = names

    @property
    def constant(self):
        """The value of an expression without names, else None."""
        return None if self.names else self({}, "numpy")

    def __call__(self, values: Mapping[str, object], lib: str = "torch"):
        funcs = _LIBS[lib]

        def ev(node):
            if isinstance(node, ast.Constant):
                return float(node.value)
            if isinstance(node, ast.Name):
                return CONSTANTS[node.id] if node.id in CONSTANTS else values[node.id]
            if isinstance(node, ast.BinOp):
                return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
            if isinstance(node, ast.UnaryOp):
                v = ev(node.operand)
                return -v if isinstance(node.op, ast.USub) else v
            arg = ev(node.args[0])
            if isinstance(arg, float):
                return float(_LIBS["numpy"][node.func.id](np.float64(arg)))
            return funcs[node.func.id](arg)

        return _as_float(ev(self._tree))

    def __repr__(self):
        return f"Expression({self.text!r})"


def read_expression(text: str, what: str = "expression") -> Expression:
    """Parse ``text`` (see the module docstring); raises
    ``NotImplementedError`` naming any form outside the grammar."""
    try:
        tree = ast.parse(text.strip(), mode="eval").body
    except SyntaxError as e:
        raise NotImplementedError(f"{what} = {text!r} is not an expression this reader takes: {e.msg}") from None
    names: Dict[str, None] = {}

    def check(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
                and not isinstance(node.value, bool):
            return
        if isinstance(node, ast.Name):
            if node.id not in CONSTANTS:
                names[node.id] = None
            return
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            check(node.left)
            check(node.right)
            return
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
            check(node.operand)
            return
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in FUNCTIONS
                and len(node.args) == 1 and not node.keywords):
            check(node.args[0])
            return
        form = ast.get_source_segment(text.strip(), node) or type(node).__name__
        raise NotImplementedError(f"{what} = {text!r}: the form {form!r} is not read without sympy (numbers, pi, "
                                  f"E, + - * / **, {' '.join(FUNCTIONS)} and names are)")

    check(tree)
    return Expression(text, tree, tuple(names))
