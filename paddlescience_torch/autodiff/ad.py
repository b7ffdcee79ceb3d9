"""Array-level derivative API over a per-evaluation tape (counterpart of
``paddlescience_tpu/autodiff/ad.py``).

Equations are written as ``jacobian(out["u"], out["x"])`` on the tensors
of an evaluation. A :class:`Tape` records, for every tensor that a model
forward or a derivative request produced, which derivative-stack entry it
is; ``jacobian`` and ``hessian`` look the tensor up and return the
requested component.

A :class:`_DerivStack` serves the components of one model over a point
batch in two ways, as the JAX package does:

* the model's fused Taylor-jet forward (``jet_fn``) serves every
  multi-index of order <= 2 in one pass (``precompute``);
* nested forward-mode derivatives (``torch.func.jvp``) of the model's
  plain batched forward along one-hot tangents serve any order, on stacks
  without a jet (the ``jvp`` candidate, ``PSCI_JET=0``; models without a
  jet forward; models with per-point extras) and above order 2 on stacks
  with one. This path never runs a fused jet segment: those are once
  differentiable and have no forward-mode rule.

Composed expressions stay differentiable: a :class:`TapeArray` carries,
beside its batched value, its point function ``pf(x, extras)`` (the same
quantity as a function of the stack's coordinates), and differentiating
it applies a jvp to that function. The parameter gradient of every
component flows through the nested dual tensors by ordinary autograd.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "Tape",
    "TapeArray",
    "current_tape",
    "tape_context",
    "jacobian",
    "hessian",
    "clear",
    "jacobian_fn",
    "hessian_fn",
    "unwrap",
    "stop_gradient",
    "wrap_tape_outputs",
]

PointFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


def _one_hot(x: torch.Tensor, j: int) -> torch.Tensor:
    """The tangent e_j on every row of ``x`` (filled on the device: no host
    copy, so a CUDA graph can capture it)."""
    t = torch.zeros_like(x)
    t.select(-1, j).fill_(1.0)
    return t


def _jvp_along(g: Callable[[torch.Tensor], torch.Tensor], j: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """v -> d g(v) / d v_j, a forward-mode derivative along coordinate j."""
    return lambda v: torch.func.jvp(g, (v,), (_one_hot(v, j),))[1]


def _nested_jvp(fn: PointFn, x: torch.Tensor, extras: Dict[str, torch.Tensor],
                dmulti: Sequence[int]) -> torch.Tensor:
    """d^k fn / dx_{j1}..dx_{jk} on the (N, d) batch ``x``, as (N, m).

    The JAX package vmaps a per-point nested jvp over the batch. Here ``fn``
    is the model's batched forward and the one-hot tangent is broadcast over
    the rows: every model on this path maps each row on its own (no batch
    statistics, no mixing of rows), so row i of the batched jvp is the jvp
    of the point function at row i, and no vmap is needed. Per-point
    extras ride along unchanged, as constants of the derivative."""
    g = lambda v: fn(v, extras)
    for j in dmulti:
        g = _jvp_along(g, j)
    return g(x)


class _DerivStack:
    """Derivative components of one pointwise function over a point batch.

    ``fn(x, extras) -> (N, m)``: the model's plain batched forward as a
    function of the (N, d) coordinates ``x`` (and the per-point ``extras``);
    ``jet_fn(x, dmultis) -> {dmulti: (N, m)}`` the model's fused jet forward,
    or None.
    """

    def __init__(
        self,
        fn: PointFn,
        x: torch.Tensor,
        key_index: Dict[str, int],
        out_index: Dict[str, int],
        extras: Optional[Dict[str, torch.Tensor]] = None,
        jet_fn: Optional[Callable] = None,
        out_width: Optional[int] = None,
    ):
        self.fn = fn
        self.x = x
        self.key_index = key_index  # coordinate key -> input column
        self.out_index = out_index  # output key -> output column
        self.extras = extras if extras is not None else {}
        self.jet_fn = jet_fn
        self.requested: Dict[Tuple[int, ...], None] = {}  # ordered set
        self.collect_only = False  # request-collection replay
        if out_width is None:
            out_width = max(out_index.values()) + 1 if out_index else 1
        self.out_width = out_width
        self._components: Dict[Tuple[int, ...], torch.Tensor] = {}

    def get_component(self, dmulti: Tuple[int, ...]) -> torch.Tensor:
        """d^k f / dx_{i1}..dx_{ik} as (N, m). Mixed partials commute, so the
        multi-index is sorted. Order <= 2 comes from the jet where the stack
        has one; anything else from nested jvp."""
        dmulti = tuple(sorted(dmulti))
        self.requested[dmulti] = None
        if self.collect_only:
            return self.x.new_zeros(self.x.shape[:-1] + (self.out_width,))
        if dmulti not in self._components:
            if self.jet_fn is not None and 0 < len(dmulti) <= 2:
                self._components.update(self.jet_fn(self.x, [dmulti]))
            else:
                self._components[dmulti] = _nested_jvp(self.fn, self.x, self.extras, dmulti)
        return self._components[dmulti]

    def precompute(self, dmultis) -> None:
        """Fill the component cache for all order <= 2 requests in one fused
        Taylor-jet forward; higher orders (and stacks without a jet) stay on
        the nested-jvp path."""
        if self.jet_fn is None:
            return
        eligible = [m for m in dmultis if 0 < len(m) <= 2 and m not in self._components]
        if eligible:
            self._components.update(self.jet_fn(self.x, eligible))

    def clear(self) -> None:
        self._components.clear()


class _GridStack:
    """Derivative components of a separable model on a product grid
    (SPINN): ``fn(*coords) -> (N_1, ..., N_d, m)`` of one (N_i, 1) column
    per axis. Output [i, j, k] depends only on the i-th, j-th and k-th
    coordinates, so the derivative along axis j is one forward-mode
    derivative with an all-ones tangent on that axis's column (the cross
    terms vanish by separability): a component costs one nested jvp of the
    model, O(N d) network evaluations, as the JAX package's grid stack."""

    def __init__(self, fn: Callable, coords: Dict[str, torch.Tensor], key_index: Dict[str, int],
                 out_index: Dict[str, int]):
        self.fn = fn
        self.coord_keys = list(coords)
        self.coords = [coords[k] for k in self.coord_keys]
        self.key_index = key_index
        self.out_index = out_index
        self.extras: Dict[str, torch.Tensor] = {}
        self.requested: Dict[Tuple[int, ...], None] = {}
        self.collect_only = False
        self._components: Dict[Tuple[int, ...], torch.Tensor] = {}

    def get_component(self, dmulti: Tuple[int, ...]) -> torch.Tensor:
        dmulti = tuple(sorted(dmulti))
        self.requested[dmulti] = None
        if dmulti not in self._components:
            g = self.fn
            for j in dmulti:
                g = (lambda g_, j_: lambda *cs: torch.func.jvp(
                    g_, cs, tuple(torch.ones_like(c) if i == j_ else torch.zeros_like(c)
                                  for i, c in enumerate(cs)))[1])(g, j)
            self._components[dmulti] = g(*self.coords)
        return self._components[dmulti]

    def precompute(self, dmultis) -> None:
        """No fused jet on a grid: components come one jvp each."""

    def clear(self) -> None:
        self._components.clear()


class _Record:
    """Provenance of one tensor: which stack, output column, and which
    coordinate axes it has already been differentiated along."""

    __slots__ = ("stack", "out_col", "dmulti")

    def __init__(self, stack: _DerivStack, out_col: int, dmulti: Tuple[int, ...]):
        self.stack = stack
        self.out_col = out_col
        self.dmulti = dmulti


class Tape:
    """Per-evaluation registry mapping tensors -> derivative-stack entries.
    Entries keep a reference to their tensor so its ``id`` stays unique."""

    def __init__(self):
        self._records: Dict[int, Tuple[torch.Tensor, _Record]] = {}
        self._coords: Dict[int, Tuple[torch.Tensor, str]] = {}
        self._stacks: List[_DerivStack] = []
        self.collecting = False  # request-collection replay

    def register_coord(self, name: str, arr: torch.Tensor) -> None:
        self._coords[id(arr)] = (arr, name)

    def add_stack(self, fn, x, key_index, out_index, extras=None, jet_fn=None, out_width=None) -> _DerivStack:
        stack = _DerivStack(fn, x, key_index, out_index, extras=extras, jet_fn=jet_fn, out_width=out_width)
        stack.collect_only = self.collecting
        self._stacks.append(stack)
        return stack

    def register_output(self, arr, stack: _DerivStack, out_col: int, dmulti: Tuple[int, ...] = ()) -> None:
        self._records[id(arr)] = (arr, _Record(stack, out_col, dmulti))

    def lookup(self, arr) -> Optional[_Record]:
        hit = self._records.get(id(arr))
        return hit[1] if hit is not None else None

    def coord_name(self, arr) -> Optional[str]:
        hit = self._coords.get(id(arr))
        return hit[1] if hit is not None else None

    def clear(self) -> None:
        for stack in self._stacks:
            stack.clear()
        self._records.clear()

    def add_grid_stack(self, fn, coords, key_index, out_index) -> _GridStack:
        stack = _GridStack(fn, coords, key_index, out_index)
        self._stacks.append(stack)
        return stack

    def derivative(self, rec: _Record, j: int) -> torch.Tensor:
        dmulti = rec.dmulti + (j,)
        comp = rec.stack.get_component(dmulti)
        out = comp[..., rec.out_col : rec.out_col + 1]
        self.register_output(out, rec.stack, rec.out_col, dmulti)
        return out


class TapeArray:
    """A batched tensor paired with its point function, tied to the
    derivative stack it came from.

    ``value``: the (N, w) tensor an expression uses; ``pf(x, extras)`` the
    same quantity as a function of the stack's (N, d) coordinates.
    Arithmetic on TapeArrays of one stack (and with numbers) composes both,
    so ``jacobian``/``hessian`` can differentiate the result; mixing with a
    batched tensor or another stack's TapeArray gives a plain tensor, whose
    later ``jacobian`` raises. ``torch`` functions do not take a TapeArray:
    use its methods (``.sin()``, ``abs()``, ...) or :func:`unwrap`.
    """

    __slots__ = ("value", "pf", "stack")

    def __init__(self, value: torch.Tensor, pf: PointFn, stack: _DerivStack):
        self.value = value
        self.pf = pf
        self.stack = stack

    @property
    def shape(self):
        return self.value.shape

    @property
    def ndim(self):
        return self.value.ndim

    @property
    def dtype(self):
        return self.value.dtype

    def __getitem__(self, idx):
        return self.value[idx]

    def __repr__(self):
        return f"TapeArray({self.value!r})"

    def _binop(self, other, op, reflected=False):
        apply = (lambda a, b: op(b, a)) if reflected else op
        if isinstance(other, TapeArray):
            if other.stack is not self.stack:
                return apply(self.value, other.value)
            f, g = self.pf, other.pf
            return TapeArray(apply(self.value, other.value), lambda x, ex: apply(f(x, ex), g(x, ex)), self.stack)
        if isinstance(other, (int, float)) or getattr(other, "ndim", None) == 0:
            f = self.pf
            return TapeArray(apply(self.value, other), lambda x, ex: apply(f(x, ex), other), self.stack)
        return apply(self.value, other)  # a batched tensor: a plain result

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: a + b, reflected=True)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: a - b, reflected=True)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: a * b, reflected=True)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: a / b, reflected=True)

    def __pow__(self, e):
        if isinstance(e, (int, float)):
            f = self.pf
            return TapeArray(self.value**e, lambda x, ex: f(x, ex) ** e, self.stack)
        return self.value ** unwrap(e)

    def __neg__(self):
        return self._unary(torch.neg)

    def __abs__(self):
        return self._unary(torch.abs)

    def _unary(self, fn):
        f = self.pf
        return TapeArray(fn(self.value), lambda x, ex: fn(f(x, ex)), self.stack)

    def tanh(self):
        return self._unary(torch.tanh)

    def exp(self):
        return self._unary(torch.exp)

    def sin(self):
        return self._unary(torch.sin)

    def cos(self):
        return self._unary(torch.cos)

    def sqrt(self):
        return self._unary(torch.sqrt)

    # comparisons give plain boolean tensors
    def __lt__(self, o):
        return self.value < unwrap(o)

    def __le__(self, o):
        return self.value <= unwrap(o)

    def __gt__(self, o):
        return self.value > unwrap(o)

    def __ge__(self, o):
        return self.value >= unwrap(o)


def unwrap(v):
    """TapeArray -> its tensor; anything else passes through."""
    return v.value if isinstance(v, TapeArray) else v


def stop_gradient(v):
    """``detach`` that keeps a TapeArray composable (its derivatives are
    then those of a constant)."""
    if isinstance(v, TapeArray):
        f = v.pf
        return TapeArray(v.value.detach(), lambda x, ex: f(x, ex).detach(), v.stack)
    return v.detach()


def wrap_tape_outputs(tape: Tape, out: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """TapeArray view of an ``out`` dict from ``forward_with_derivatives``:
    model outputs, and the coordinate columns when there is one stack."""
    single = tape._stacks[0] if len(tape._stacks) == 1 else None
    wrapped: Dict[str, object] = {}
    for k, v in out.items():
        rec = tape.lookup(v)
        if rec is not None and rec.dmulti == ():
            stack, col, w = rec.stack, rec.out_col, int(v.shape[-1])
            wrapped[k] = TapeArray(v, lambda x, ex, _s=stack, _c=col, _w=w: _s.fn(x, ex)[..., _c : _c + _w], stack)
            continue
        name = tape.coord_name(v)
        if name is not None and single is not None and name in single.key_index:
            i = single.key_index[name]
            wrapped[k] = TapeArray(v, lambda x, ex, _i=i: x[..., _i : _i + 1], single)
            continue
        wrapped[k] = v
    return wrapped


_CURRENT_TAPE: contextvars.ContextVar[Optional[Tape]] = contextvars.ContextVar(
    "psci_torch_tape", default=None
)


def current_tape() -> Optional[Tape]:
    return _CURRENT_TAPE.get()


@contextlib.contextmanager
def tape_context(tape: Optional[Tape] = None):
    tape = tape if tape is not None else Tape()
    token = _CURRENT_TAPE.set(tape)
    try:
        yield tape
    finally:
        _CURRENT_TAPE.reset(token)


def _require_tape() -> Tape:
    tape = current_tape()
    if tape is None:
        raise RuntimeError(
            "No active autodiff tape. `jacobian`/`hessian` on tensors only work inside "
            "constraint/equation evaluation (the expression evaluator opens a tape). "
            "For standalone use, see `jacobian_fn`/`hessian_fn`."
        )
    return tape


def _record_pf(stack: _DerivStack, out_col: int, dmulti: Tuple[int, ...]) -> PointFn:
    """Point function of a registered derivative component: evaluated only
    when a composed expression built from it is differentiated further
    (the component's value itself comes from the stack)."""
    return lambda x, ex: _nested_jvp(stack.fn, x, ex, dmulti)[..., out_col : out_col + 1]


def _input_col(tape: Tape, stack: _DerivStack, xs, j: Optional[int]) -> int:
    """The stack's input column of the coordinate ``xs`` (or column ``j``
    of the concatenated coordinates)."""
    name = tape.coord_name(unwrap(xs))
    if name is not None:
        if name not in stack.key_index:
            raise ValueError(f"coordinate '{name}' is not an input of the differentiated model")
        return stack.key_index[name]
    if j is not None:
        return int(j)
    raise ValueError(
        "xs is not a registered input coordinate of the current tape; "
        "pass one of the tensors from the constraint input dict"
    )


def jacobian(
    ys,
    xs: Union[torch.Tensor, Sequence[torch.Tensor]],
    i: int = 0,
    j: Optional[int] = None,
):
    """d(ys)/d(xs) on tape-registered tensors. ``xs`` may be a list of
    coordinate columns, in which case a list of derivatives is returned.
    ``jacobian(jacobian(u, x), x)`` resolves to the (x, x) component; the
    jacobian of a composed TapeArray (``u * v``) differentiates its point
    function."""
    tape = _require_tape()
    if isinstance(xs, (list, tuple)):
        return [jacobian(ys, x, i, j) for x in xs]
    rec = tape.lookup(unwrap(ys))
    if rec is None:
        if isinstance(ys, TapeArray):
            return _tracked_jacobian(tape, ys, xs, i, j)
        raise ValueError(
            "ys is not on the autodiff tape; differentiate model outputs or "
            "derivatives thereof (tensors produced inside equation evaluation)"
        )
    col = _input_col(tape, rec.stack, xs, j)
    rec = _Record(rec.stack, rec.out_col + i, rec.dmulti)
    out = tape.derivative(rec, col)
    if isinstance(ys, TapeArray):
        return TapeArray(out, _record_pf(rec.stack, rec.out_col, rec.dmulti + (col,)), rec.stack)
    return out


def _tracked_jacobian(tape: Tape, ys: TapeArray, xs, i: int, j: Optional[int]) -> TapeArray:
    """Derivative of a composed expression: a jvp of its point function
    over the stack's batch."""
    stack = ys.stack
    col = _input_col(tape, stack, xs, j)
    dpf = lambda x, ex, _f=ys.pf: _jvp_along(lambda v: _f(v, ex), col)(x)[..., i : i + 1]
    return TapeArray(dpf(stack.x, stack.extras), dpf, stack)


def hessian(ys, xs, component: Optional[int] = None, i: int = 0, j: int = 0):
    """Second derivative d2(ys)/d(xs_i)d(xs_j). With single-column
    coordinates (the convention) it equals ``jacobian(jacobian(ys, xs),
    xs)``, taken directly as the order-2 component; ``xs=None`` takes input
    columns ``i`` and ``j``."""
    tape = _require_tape()
    rec = tape.lookup(unwrap(ys))
    if rec is None:
        if isinstance(ys, TapeArray):
            first = _tracked_jacobian(tape, ys, xs, component or 0, i if xs is None else None)
            return _tracked_jacobian(tape, first, xs, 0, j if xs is None else None)
        raise ValueError("ys is not on the autodiff tape")
    out_col = rec.out_col + (component if component is not None else 0)
    if xs is None:
        ci, cj = int(i), int(j)
    else:
        ci = cj = _input_col(tape, rec.stack, xs, None)
    dmulti = rec.dmulti + (ci, cj)
    out = rec.stack.get_component(dmulti)[..., out_col : out_col + 1]
    tape.register_output(out, rec.stack, out_col, dmulti)
    if isinstance(ys, TapeArray):
        return TapeArray(out, _record_pf(rec.stack, out_col, dmulti), rec.stack)
    return out


def clear() -> None:
    """Drop the cached derivative components of the current tape. Each
    evaluation opens a fresh tape, so this is only needed for manual loops
    that share one."""
    tape = current_tape()
    if tape is not None:
        tape.clear()


# -- standalone functional API -------------------------------------------------


def jacobian_fn(fn: Callable, argnums: int = 0) -> Callable:
    """Functional jacobian of a pointwise ``fn`` (d,) -> (m,), mapped over a
    leading batch axis: returns g(x: (N, d)) -> (N, m, d).

    Examples:
        >>> import torch
        >>> from paddlescience_torch.autodiff import jacobian_fn
        >>> g = jacobian_fn(lambda x: x ** 3)
        >>> g(torch.tensor([[2.0]])).shape
        torch.Size([1, 1, 1])
        >>> float(g(torch.tensor([[2.0]]))[0, 0, 0])  # d(x^3)/dx at x=2
        12.0
    """
    return torch.func.vmap(torch.func.jacfwd(fn, argnums=argnums))


def hessian_fn(fn: Callable, argnums: int = 0) -> Callable:
    """Functional hessian (forward over forward): g(x: (N, d)) -> (N, m, d, d).

    Examples:
        >>> import torch
        >>> from paddlescience_torch.autodiff import hessian_fn
        >>> h = hessian_fn(lambda x: x ** 3)
        >>> float(h(torch.tensor([[2.0]]))[0, 0, 0, 0])  # d2(x^3)/dx2 at x=2
        12.0
    """
    return torch.func.vmap(torch.func.jacfwd(torch.func.jacfwd(fn, argnums=argnums), argnums=argnums))
