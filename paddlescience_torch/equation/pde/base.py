"""PDE base class (counterpart of ``paddlescience_tpu/equation/pde/base.py``).

Holds ``equations: Dict[str, Callable]`` of python-closure residuals. The
sympy forms of the JAX package are not ported: sympy is not installed
where the port runs, so every sympy-form PDE needs a sympy-free lowering
first. Learnable equation parameters (inverse problems) come later too.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

__all__ = ["PDE"]


class PDE:
    """Base class for partial differential equations."""

    def __init__(self):
        self.equations: Dict[str, Callable] = {}
        self.learnable_parameters: Dict[str, object] = {}
        self.detach_keys: Optional[Tuple[str, ...]] = None

    def add_equation(self, name: str, equation: Callable) -> None:
        if not callable(equation):
            raise TypeError(f"equation '{name}' must be a python closure over the output dict")
        self.equations[name] = equation
