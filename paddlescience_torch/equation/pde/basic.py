"""Named PDEs (counterpart of ``paddlescience_tpu/equation/pde/basic.py``).

Ported: ``AllenCahn`` (closure form). The sympy-form PDEs (Laplace,
Poisson, NavierStokes, ...) need a sympy-free lowering first.
"""

from __future__ import annotations

from typing import Optional, Tuple

from paddlescience_torch.autodiff.ad import jacobian
from paddlescience_torch.equation.pde.base import PDE

__all__ = ["AllenCahn"]


class AllenCahn(PDE):
    """u_t - eps^2 u_xx + 5 u^3 - 5 u = 0 (u*u*u instead of a power, as in
    the JAX package)."""

    def __init__(self, eps: float, detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        self.detach_keys = detach_keys
        self.eps = eps

        def allen_cahn(out):
            t, x, u = out["t"], out["x"], out["u"]
            u__t, u__x = jacobian(u, [t, x])
            u__x__x = jacobian(u__x, x)
            return u__t - (self.eps**2) * u__x__x + 5 * u * u * u - 5 * u

        self.add_equation("allen_cahn", allen_cahn)
