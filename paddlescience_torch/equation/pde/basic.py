"""Named PDEs (counterpart of ``paddlescience_tpu/equation/pde/basic.py``).

Every equation of the JAX module, in closure form (sympy is not installed
where the port runs): ``AllenCahn`` and ``Helmholtz`` (closures there
too), and the sympy forms ``Laplace``, ``Poisson``, ``Biharmonic``,
``NavierStokes``, ``NormalDotVec``, ``LinearElasticity`` and
``Vibration`` written out by hand, each term a derivative component of a
network (``PDE.d``, honouring ``detach_keys``). A coefficient given as a
string is a field ``out[name]``, as the JAX package's sympy function or
symbol of that name; none is differentiated in these equations.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from paddlescience_torch.autodiff.ad import hessian, jacobian
from paddlescience_torch.equation.pde.base import PDE, parse_coefficient
from paddlescience_torch.utils.symbolic import Expression

__all__ = ["AllenCahn", "Laplace", "Poisson", "Helmholtz", "Biharmonic", "NavierStokes", "NormalDotVec",
           "LinearElasticity", "Vibration"]

AXES = ("x", "y", "z")


class AllenCahn(PDE):
    """u_t - eps^2 u_xx + 5 u^3 - 5 u = 0 (u*u*u instead of a power, as in
    the JAX package). A closure in the JAX package too, so ``detach_keys``
    is kept and not applied, as there."""

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


def _check_dim(dim: int, dims=(1, 2, 3)) -> None:
    if dim not in dims:
        raise ValueError(f"dim must be one of {dims}, got {dim}")


class Laplace(PDE):
    """``laplace = sum_i u_{x_i x_i}`` over the first ``dim`` of x, y, z
    (the JAX package's sympy form, ``basic.py:60-73``)."""

    def __init__(self, dim: int, detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        _check_dim(dim)
        self.detach_keys = detach_keys
        self.dim = dim

        def laplace(out):
            return sum(self.d(out, "u", a, a) for a in AXES[:dim])

        self.add_equation("laplace", laplace)


class Poisson(PDE):
    """``poisson = sum_i p_{x_i x_i}`` over the first ``dim`` of x, y, z
    (the JAX package's sympy form, ``basic.py:76-89``)."""

    def __init__(self, dim: int, detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        _check_dim(dim)
        self.detach_keys = detach_keys
        self.dim = dim

        def poisson(out):
            return sum(self.d(out, "p", a, a) for a in AXES[:dim])

        self.add_equation("poisson", poisson)


class Helmholtz(PDE):
    """``helmholtz = k^2 u + sum_i u_{x_i x_i}``. A closure in the JAX
    package too (``basic.py:92-108``), so ``detach_keys`` is kept and not
    applied, as there."""

    def __init__(self, dim: int, k: float, detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        _check_dim(dim)
        self.dim = dim
        self.k = k
        self.detach_keys = detach_keys

        def helmholtz(out):
            u = out["u"]
            result = (self.k**2) * u
            for axis in AXES[: self.dim]:
                result = result + hessian(u, out[axis])
            return result

        self.add_equation("helmholtz", helmholtz)


class Biharmonic(PDE):
    """``biharmonic = sum_ij d4u / dx_i^2 dx_j^2 - q / D`` over the first
    ``dim`` of x, y, z (the JAX package's sympy form, ``basic.py:111-137``).
    Each term is one component of order 4: the nested-jvp path serves it
    (the jet serves order <= 2). A string ``q`` or ``D`` is a field
    ``out[name]``, only divided, never differentiated."""

    def __init__(self, dim: int, q: Union[float, str], D: Union[float, str],
                 detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        _check_dim(dim)
        self.detach_keys = detach_keys
        self.dim = dim
        self.q = q if isinstance(q, str) else float(q)
        self.D = D if isinstance(D, str) else float(D)
        axes = AXES[:dim]

        def biharmonic(out):
            result = -self.coefficient(out, self.q) / self.coefficient(out, self.D)
            for a in axes:
                for b in axes:
                    result = result + self.d(out, "u", a, a, b, b)
            return result

        self.add_equation("biharmonic", biharmonic)


class NavierStokes(PDE):
    """Incompressible Navier-Stokes, ``dim`` 2 or 3, steady or unsteady
    (``time``): the four residuals of the JAX package's sympy form
    (``basic.py:140-216``),

        continuity = u_x + v_y (+ w_z)
        momentum_x = u_t + u u_x + v u_y (+ w u_z)
                     - nu (u_xx + u_yy (+ u_zz)) + p_x / rho

    and likewise momentum_y, momentum_z. ``nu`` and ``rho`` are numbers or
    strings (:func:`~paddlescience_torch.equation.pde.base.parse_coefficient`):
    a number's arithmetic is that number; a bare identifier is the field
    ``out[name]``, which the JAX package makes an independent variable, so
    ``(nu u_x)_x = nu u_xx``; an expression of fields is evaluated on them,
    and where it names a coordinate the JAX form's product rule
    ``(nu u_x)_x = nu u_xx + nu_x u_x`` brings its derivative along that
    coordinate (a forward-mode derivative of the expression; the other
    names are independent variables, as in sympy)."""

    def __init__(self, nu: Union[float, str], rho: Union[float, str], dim: int, time: bool,
                 detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        _check_dim(dim, (2, 3))
        self.detach_keys = detach_keys
        self.nu, self.rho = parse_coefficient(nu, "nu"), parse_coefficient(rho, "rho")
        self.dim, self.time = dim, time
        vel = ("u", "v", "w")[:dim]
        axes = AXES[:dim]

        def continuity(out):
            return sum(self.d(out, c, a) for c, a in zip(vel, axes))

        def momentum(k):
            q = vel[k]

            def residual(out):
                r = self.d(out, q, "t") if time else 0.0
                for c, a in zip(vel, axes):
                    r = r + self.d(out, c) * self.d(out, q, a)
                r = r - self.coefficient(out, self.nu) * sum(self.d(out, q, a, a) for a in axes)
                if isinstance(self.nu, Expression):
                    for a in axes:
                        if a in self.nu.names:
                            r = r - self._coefficient_derivative(out, self.nu, a) * self.d(out, q, a)
                return r + self.d(out, "p", axes[k]) / self.coefficient(out, self.rho)

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
            return sum(self.d(out, f"normal_{a}") * self.d(out, k) for a, k in zip("xyz", self.vec_keys))

        self.add_equation("normal_dot_vec", normal_dot_vec)


class LinearElasticity(PDE):
    """Linear elasticity in mixed displacement-stress form (the JAX
    package's sympy form, ``basic.py:240-326``), 2-D or 3-D, steady or with
    ``time``: displacements u, v (w) and stresses sigma_xx, sigma_yy,
    sigma_xy (sigma_zz, sigma_xz, sigma_yz) are network outputs;

        stress_disp_xx = lambda div(u) + 2 mu u_x - sigma_xx     (yy, zz alike)
        stress_disp_xy = mu (u_y + v_x) - sigma_xy               (xz, yz alike)
        equilibrium_x  = rho u_tt - (sigma_xx_x + sigma_xy_y + sigma_xz_z)
        traction_x     = n_x sigma_xx + n_y sigma_xy + n_z sigma_xz

    (u_tt is 0 without ``time``). The material is ``lambda_`` and ``mu``,
    or, when ``lambda_`` is None, ``E`` and ``nu`` (lambda = nu E / ((1 +
    nu)(1 - 2 nu)), mu = E / (2 (1 + nu))). Each of them and ``rho`` is a
    number or a string naming a field ``out[name]`` (another network's
    output, as the inverse problem's Lame fields), never differentiated.
    The equation names and their order are the JAX package's."""

    def __init__(self, E: Optional[Union[float, str]] = None, nu: Optional[Union[float, str]] = None,
                 lambda_: Optional[Union[float, str]] = None, mu: Optional[Union[float, str]] = None,
                 rho: Union[float, str] = 1, dim: int = 3, time: bool = False,
                 detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        _check_dim(dim, (2, 3))
        if lambda_ is None and (E is None or nu is None):
            raise ValueError("LinearElasticity needs lambda_ and mu, or E and nu")
        if lambda_ is not None and mu is None:
            raise ValueError("LinearElasticity: lambda_ is given without mu")
        field = lambda c: c if isinstance(c, str) or c is None else float(c)
        self.detach_keys = detach_keys
        self.dim, self.time = dim, time
        self.E, self.nu, self.lambda_, self.mu, self.rho = map(field, (E, nu, lambda_, mu, rho))
        vel = ("u", "v", "w")[:dim]
        axes = AXES[:dim]

        def lame(out):
            if self.lambda_ is not None:
                return self.coefficient(out, self.lambda_), self.coefficient(out, self.mu)
            e, n = self.coefficient(out, self.E), self.coefficient(out, self.nu)
            return n * e / ((1 + n) * (1 - 2 * n)), e / (2 * (1 + n))

        def stress_disp_normal(i):
            def residual(out):
                lam, mu_ = lame(out)
                div = sum(self.d(out, c, a) for c, a in zip(vel, axes))
                return lam * div + 2 * mu_ * self.d(out, vel[i], axes[i]) - self.d(out, f"sigma_{axes[i] * 2}")

            return residual

        def stress_disp_shear(i, j):
            def residual(out):
                _, mu_ = lame(out)
                shear = self.d(out, vel[i], axes[j]) + self.d(out, vel[j], axes[i])
                return mu_ * shear - self.d(out, f"sigma_{axes[i]}{axes[j]}")

            return residual

        def sigma(i, j):
            return f"sigma_{axes[min(i, j)]}{axes[max(i, j)]}"

        def equilibrium(i):
            def residual(out):
                div = sum(self.d(out, sigma(i, j), axes[j]) for j in range(dim))
                if not time:
                    return -div
                return self.coefficient(out, self.rho) * self.d(out, vel[i], "t", "t") - div

            return residual

        def traction(i):
            def residual(out):
                return sum(self.d(out, f"normal_{axes[j]}") * self.d(out, sigma(i, j)) for j in range(dim))

            return residual

        # the JAX order: xx, yy, xy (then zz, xz, yz)
        self.add_equation("stress_disp_xx", stress_disp_normal(0))
        self.add_equation("stress_disp_yy", stress_disp_normal(1))
        self.add_equation("stress_disp_xy", stress_disp_shear(0, 1))
        if dim == 3:
            self.add_equation("stress_disp_zz", stress_disp_normal(2))
            self.add_equation("stress_disp_xz", stress_disp_shear(0, 2))
            self.add_equation("stress_disp_yz", stress_disp_shear(1, 2))
        for i in range(dim):
            self.add_equation(f"equilibrium_{axes[i]}", equilibrium(i))
        for i in range(dim):
            self.add_equation(f"traction_{axes[i]}", traction(i))


class Vibration(PDE):
    """The vortex-induced-vibration ODE ``f = rho eta_tt + exp(k1) eta_t +
    exp(k2) eta`` over ``t_f`` (the JAX package's sympy form,
    ``basic.py:329-342``) with learnable ``k1`` and ``k2``."""

    def __init__(self, rho: float, k1: float, k2: float):
        super().__init__()
        self.rho = rho
        self.create_parameter("k1", k1)
        self.create_parameter("k2", k2)

        def f(out):
            return (self.rho * self.d(out, "eta", "t_f", "t_f")
                    + torch.exp(self.param("k1")) * self.d(out, "eta", "t_f")
                    + torch.exp(self.param("k2")) * self.d(out, "eta"))

        self.add_equation("f", f)
