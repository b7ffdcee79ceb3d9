"""More named PDEs (counterpart of ``paddlescience_tpu/equation/pde/extra.py``):
``NLSMB``, ``HeatExchanger`` and ``Hooke``, the JAX package's sympy forms
written out by hand (sympy is not installed where the port runs), every
term a derivative component of order <= 2 of a network (``PDE.d``,
honouring ``detach_keys``).

Hooke differentiates products of material fields and strains; with a
field ``E``, ``nu`` or ``P`` (a string naming ``out[name]``), the product
rule brings that field's first derivatives. :class:`_Dual` applies it by
hand: a value with its first derivatives along x, y, z, each taken from
the network only when a residual asks for it, so a traction residual
requests no second derivative.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

from paddlescience_torch.equation.pde.base import PDE, parse_coefficient

__all__ = ["NLSMB", "HeatExchanger", "Hooke"]

AXES = ("x", "y", "z")


class NLSMB(PDE):
    """Nonlinear Schrodinger-Maxwell-Bloch system over (t, x) (the JAX
    package's sympy form, ``extra.py:15-52``):

        Schrodinger_1 = a1 Eu_tt - a2 Eu (Eu^2 + Ev^2) + 2 pv - Ev_x
        Schrodinger_2 = a1 Ev_tt - a2 Ev (Eu^2 + Ev^2) - 2 pu + Eu_x
        Maxwell_1     = 2 Ev eta - pv_t + 2 pu omega_0
        Maxwell_2     = -2 Eu eta + pu_t + 2 pv omega_0
        Bloch         = 2 pv Ev + 2 pu Eu + eta_t

    (a derivative along t is 0 without ``time``). ``alpha_1``, ``alpha_2``
    and ``omega_0`` are numbers or strings read as the JAX package's sympy
    parser reads them (:func:`~paddlescience_torch.equation.pde.base.parse_coefficient`)."""

    def __init__(self, alpha_1: Union[float, str], alpha_2: Union[float, str], omega_0: Union[float, str],
                 time: bool, detach_keys: Optional[Tuple[str, ...]] = None):
        super().__init__()
        self.detach_keys = detach_keys
        self.time = time
        self.alpha_1 = parse_coefficient(alpha_1, "alpha_1")
        self.alpha_2 = parse_coefficient(alpha_2, "alpha_2")
        self.omega_0 = parse_coefficient(omega_0, "omega_0")

        def dt(out, name, order=1):
            return self.d(out, name, *("t",) * order) if time else 0.0

        def schrodinger(a, b, p, sign):
            def residual(out):
                power = self.d(out, "Eu") * self.d(out, "Eu") + self.d(out, "Ev") * self.d(out, "Ev")
                return (self.coefficient(out, self.alpha_1) * dt(out, a, 2)
                        - self.coefficient(out, self.alpha_2) * self.d(out, a) * power
                        + sign * 2 * self.d(out, p) - sign * self.d(out, b, "x"))

            return residual

        def maxwell_1(out):
            return (2 * self.d(out, "Ev") * self.d(out, "eta") - dt(out, "pv")
                    + 2 * self.d(out, "pu") * self.coefficient(out, self.omega_0))

        def maxwell_2(out):
            return (-2 * self.d(out, "Eu") * self.d(out, "eta") + dt(out, "pu")
                    + 2 * self.d(out, "pv") * self.coefficient(out, self.omega_0))

        def bloch(out):
            return (2 * self.d(out, "pv") * self.d(out, "Ev") + 2 * self.d(out, "pu") * self.d(out, "Eu")
                    + dt(out, "eta"))

        self.add_equation("Schrodinger_1", schrodinger("Eu", "Ev", "pv", 1))
        self.add_equation("Schrodinger_2", schrodinger("Ev", "Eu", "pu", -1))
        self.add_equation("Maxwell_1", maxwell_1)
        self.add_equation("Maxwell_2", maxwell_2)
        self.add_equation("Bloch", bloch)


class HeatExchanger(PDE):
    """The 1-D heat exchanger over (x, t) with the mass flows ``qm_h``,
    ``qm_c`` as inputs (the JAX package's sympy form, ``extra.py:55-83``):

        heat_boundary = T_h_t + v_h T_h_x - beta_h (T_w - T_h)
        cold_boundary = T_c_t - v_c T_c_x - beta_c (T_w - T_c)
        wall          = T_w_t - w_h (T_h - T_w) - w_c (T_c - T_w)

    with beta_h = alpha_h v_h / qm_h and beta_c = alpha_c v_c / qm_c. Each
    coefficient is a number or a string as in :class:`NLSMB`."""

    def __init__(self, alpha_h: Union[float, str], alpha_c: Union[float, str], v_h: Union[float, str],
                 v_c: Union[float, str], w_h: Union[float, str], w_c: Union[float, str]):
        super().__init__()
        names = ("alpha_h", "alpha_c", "v_h", "v_c", "w_h", "w_c")
        values = (alpha_h, alpha_c, v_h, v_c, w_h, w_c)
        for name, value in zip(names, values):
            setattr(self, name, parse_coefficient(value, name))
        c = lambda out, name: self.coefficient(out, getattr(self, name))

        def heat_boundary(out):
            beta_h = c(out, "alpha_h") * c(out, "v_h") / self.d(out, "qm_h")
            return (self.d(out, "T_h", "t") + c(out, "v_h") * self.d(out, "T_h", "x")
                    - beta_h * (self.d(out, "T_w") - self.d(out, "T_h")))

        def cold_boundary(out):
            beta_c = c(out, "alpha_c") * c(out, "v_c") / self.d(out, "qm_c")
            return (self.d(out, "T_c", "t") - c(out, "v_c") * self.d(out, "T_c", "x")
                    - beta_c * (self.d(out, "T_w") - self.d(out, "T_c")))

        def wall(out):
            return (self.d(out, "T_w", "t") - c(out, "w_h") * (self.d(out, "T_h") - self.d(out, "T_w"))
                    - c(out, "w_c") * (self.d(out, "T_c") - self.d(out, "T_w")))

        self.add_equation("heat_boundary", heat_boundary)
        self.add_equation("cold_boundary", cold_boundary)
        self.add_equation("wall", wall)


def _zero(v) -> bool:
    return isinstance(v, (int, float)) and v == 0


def _add(a, b):
    return b if _zero(a) else a if _zero(b) else a + b


def _mul(a, b):
    return 0.0 if _zero(a) or _zero(b) else a * b


class _Dual:
    """A value and its first derivatives along the spatial axes, the
    derivatives taken only when asked for (``grad(axis)``; 0.0 for a
    constant), with + - * / by the product and quotient rules."""

    __slots__ = ("value", "_grad")

    def __init__(self, value, grad: Optional[Callable[[str], object]] = None):
        self.value = value
        self._grad = grad

    def grad(self, axis: str):
        return 0.0 if self._grad is None else self._grad(axis)

    @staticmethod
    def of(x) -> "_Dual":
        return x if isinstance(x, _Dual) else _Dual(x)

    def __add__(self, o):
        o = _Dual.of(o)
        return _Dual(_add(self.value, o.value), lambda a: _add(self.grad(a), o.grad(a)))

    __radd__ = __add__

    def __neg__(self):
        return _Dual(-self.value, lambda a: _mul(-1.0, self.grad(a)))

    def __sub__(self, o):
        return self + (-_Dual.of(o))

    def __rsub__(self, o):
        return _Dual.of(o) + (-self)

    def __mul__(self, o):
        o = _Dual.of(o)
        return _Dual(_mul(self.value, o.value),
                     lambda a: _add(_mul(self.grad(a), o.value), _mul(self.value, o.grad(a))))

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = _Dual.of(o)
        return _Dual(self.value / o.value,
                     lambda a: _add(_mul(self.grad(a), 1.0 / o.value),
                                    _mul(-1.0, _mul(self.value, _mul(o.grad(a), 1.0 / (o.value * o.value))))))

    def __rtruediv__(self, o):
        return _Dual.of(o) / self


class Hooke(PDE):
    """Isotropic Hooke-law elasticity in displacement form with a cavity
    pressure load (the JAX package's sympy form, ``extra.py:86-153``):
    strains e_ij from the displacement gradients, stresses t_ij = 2 G (e_ij
    + nu / (1 - 2 nu) tr(e) delta_ij) with G = E / (2 (1 + nu)),

        hooke_i     = sum_j d t_ij / d x_j
        traction_i  = sum_j t_ij n_j + P n_i
        traction    = sum_ij t_ij n_i n_j

    ``E`` is a number, a field name, or ``("learnable", value)`` (a
    learnable parameter named ``E``); ``nu`` and ``P`` numbers or field
    names. A field differentiated by ``hooke_*`` brings its first
    derivatives (the product rule, by :class:`_Dual`). In 3-D ``hooke_*``
    asks for all six second derivatives of the displacements: 10 jet
    streams."""

    def __init__(self, E, nu, P, dim: int = 3, time: bool = False, detach_keys=None):
        super().__init__()
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        self.detach_keys = detach_keys
        self.dim, self.time = dim, time
        if isinstance(E, (tuple, list)) and len(E) == 2 and E[0] == "learnable":
            E = ("learnable", self.create_parameter("E", float(E[1])))
        elif not isinstance(E, str):
            E = float(E)
        self.E = E
        self.nu = nu if isinstance(nu, str) else float(nu)
        self.P = P if isinstance(P, str) else float(P)
        axes = AXES[:dim]
        disp = ("u", "v", "w")[:dim]

        def material(out, c):
            """A coefficient as a _Dual: a number, the learnable E (no
            derivatives), or a field with its first derivatives."""
            if isinstance(c, tuple):
                return _Dual(self.param(c[1]))
            if isinstance(c, str):
                return _Dual(self.d(out, c), lambda a, _c=c: self.d(out, _c, a))
            return c

        def grad_u(out, i, j):
            """d disp_i / d x_j as a _Dual (its derivatives second-order
            components)."""
            return _Dual(self.d(out, disp[i], axes[j]), lambda a: self.d(out, disp[i], axes[j], a))

        def stresses(out):
            """t as a dict {(i, j): _Dual} over i <= j, and t_zz in 2-D (the
            JAX form keeps it in ``traction``)."""
            E_, nu_ = material(out, self.E), material(out, self.nu)
            G = E_ / (2 * (1 + nu_))
            ratio = nu_ / (1 - 2 * nu_)
            strain = {(i, i): grad_u(out, i, i) for i in range(dim)}
            for i in range(dim):
                for j in range(i + 1, dim):
                    strain[(i, j)] = 0.5 * (grad_u(out, i, j) + grad_u(out, j, i))
            tr = sum((strain[(i, i)] for i in range(dim)), _Dual(0.0))
            t = {(i, j): 2 * G * (e + ratio * tr) if i == j else 2 * G * e for (i, j), e in strain.items()}
            if dim == 2:
                t[(2, 2)] = 2 * G * (ratio * tr)
            return t

        def ts(t, i, j):
            return t.get((min(i, j), max(i, j)), _Dual(0.0))

        def hooke(i):
            def residual(out):
                t = stresses(out)
                return sum((ts(t, i, j).grad(axes[j]) for j in range(dim)), 0.0)

            return residual

        def normal(out, j):
            return self.d(out, f"normal_{AXES[j]}")

        def traction_vec(out, t, i):
            """sum_j t_ij n_j over the stresses the dimension has."""
            return sum(ts(t, i, j).value * normal(out, j) for j in range(3) if (min(i, j), max(i, j)) in t)

        def traction(i):
            def residual(out):
                return traction_vec(out, stresses(out), i) + _Dual.of(material(out, self.P)).value * normal(out, i)

            return residual

        def traction_normal(out):
            t = stresses(out)
            return sum(traction_vec(out, t, i) * normal(out, i) for i in range(3))

        for i in range(dim):
            self.add_equation(f"hooke_{axes[i]}", hooke(i))
        for i in range(dim):
            self.add_equation(f"traction_{axes[i]}", traction(i))
        self.add_equation("traction", traction_normal)
