"""Named PDEs (counterpart of ``paddlescience_tpu/equation/pde/basic.py``).

Ported: ``AllenCahn``, ``Laplace``, ``Biharmonic`` (constant q and D),
``NavierStokes`` (constant nu and rho) and ``NormalDotVec``, in closure
form: sympy is not installed where the port runs. The other sympy-form
PDEs (Poisson, Helmholtz, ...) need the same lowering first (ROADMAP
Queue A).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

from paddlescience_torch.autodiff.ad import hessian, jacobian
from paddlescience_torch.equation.pde.base import PDE

__all__ = ["AllenCahn", "Laplace", "Biharmonic", "NavierStokes", "NormalDotVec"]


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


class Laplace(PDE):
    """The Laplace residual in closure form (the JAX package's sympy form,
    ``basic.py:60-73``): ``laplace = sum_i u_{x_i x_i}`` over the first
    ``dim`` of x, y, z; each term one second-order component of the jet."""

    def __init__(self, dim: int, detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        if dim not in (1, 2, 3):
            raise ValueError(f"dim must be 1, 2 or 3, got {dim}")
        self.detach_keys = detach_keys
        self.dim = dim
        axes = ("x", "y", "z")[:dim]

        def laplace(out):
            u = out["u"]
            return sum(hessian(u, out[a]) for a in axes)

        self.add_equation("laplace", laplace)


class Biharmonic(PDE):
    """The biharmonic residual in closure form, for a constant ``q`` and
    ``D`` (the JAX package's sympy form, ``basic.py:111-137``):

        biharmonic = sum_ij d4u / dx_i^2 dx_j^2 - q / D

    over the first ``dim`` of x, y, z. Each term is ``hessian`` of
    ``hessian(u, x_i)`` along x_j, one component of order 4: the nested-jvp
    path serves it (the jet serves order <= 2). A string ``q`` or ``D`` (a
    sympy function of the coordinates) raises ``NotImplementedError``: its
    lowering is ROADMAP Queue A 2."""

    def __init__(self, dim: int, q: Union[float, str], D: Union[float, str],
                 detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        if isinstance(q, str) or isinstance(D, str):
            raise NotImplementedError("Biharmonic with a string q or D (a sympy function) is not ported: its "
                                      "sympy-free lowering is ROADMAP Queue A 2; pass numbers")
        if dim not in (1, 2, 3):
            raise ValueError(f"dim must be 1, 2 or 3, got {dim}")
        self.detach_keys = detach_keys
        self.dim, self.q, self.D = dim, float(q), float(D)
        axes = ("x", "y", "z")[:dim]

        def biharmonic(out):
            u = out["u"]
            result = -self.q / self.D
            for a in axes:
                u_aa = hessian(u, out[a])
                for b in axes:
                    result = result + hessian(u_aa, out[b])
            return result

        self.add_equation("biharmonic", biharmonic)


class NavierStokes(PDE):
    """Incompressible Navier-Stokes in closure form, for a constant ``nu``
    and ``rho``, ``dim`` 2 or 3, steady or unsteady (``time``): the four
    residuals of the JAX package's sympy form (``basic.py:187-216``),

        continuity = u_x + v_y (+ w_z)
        momentum_x = u_t + u u_x + v u_y (+ w u_z)
                     - nu (u_xx + u_yy (+ u_zz)) + p_x / rho

    and likewise momentum_y, momentum_z. A string ``nu`` or ``rho`` (a
    sympy expression, or a learnable symbol) is not ported: it raises
    ``NotImplementedError``."""

    def __init__(self, nu: Union[float, str], rho: Union[float, str], dim: int, time: bool,
                 detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        if isinstance(nu, str) or isinstance(rho, str):
            raise NotImplementedError("NavierStokes with a string nu or rho (a sympy expression or a learnable "
                                      "symbol) is not ported; pass numbers")
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        self.detach_keys = detach_keys
        self.nu, self.rho, self.dim, self.time = float(nu), float(rho), dim, time
        vel = ("u", "v", "w")[:dim]
        axes = ("x", "y", "z")[:dim]

        def continuity(out):
            return sum(jacobian(out[c], out[a]) for c, a in zip(vel, axes))

        def momentum(k):
            def residual(out):
                q = out[vel[k]]
                grads = jacobian(q, [out[a] for a in axes])
                r = jacobian(q, out["t"]) if time else 0.0
                for c, g in zip(vel, grads):
                    r = r + out[c] * g
                r = r - self.nu * sum(jacobian(g, out[a]) for g, a in zip(grads, axes))
                return r + jacobian(out["p"], out[axes[k]]) / self.rho

            return residual

        self.add_equation("continuity", continuity)
        for k, name in enumerate(("momentum_x", "momentum_y", "momentum_z")[:dim]):
            self.add_equation(name, momentum(k))


class NormalDotVec(PDE):
    """n . v over boundary normals: ``normal_x * v[0] + normal_y * v[1] +
    normal_z * v[2]`` for the keys in ``vec_keys``."""

    def __init__(self, vec_keys: Tuple[str, ...], detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        if not vec_keys:
            raise ValueError(f"vec_keys is {vec_keys}")
        self.detach_keys = detach_keys
        self.vec_keys = tuple(vec_keys)

        def normal_dot_vec(out):
            return sum(out[f"normal_{a}"] * out[k] for a, k in zip("xyz", self.vec_keys))

        self.add_equation("normal_dot_vec", normal_dot_vec)
