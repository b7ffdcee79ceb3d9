"""Array-level derivative API over a per-evaluation tape (counterpart of
``paddlescience_tpu/autodiff/ad.py``).

Equations are written as ``jacobian(out["u"], out["x"])`` on the tensors
of an evaluation. A :class:`Tape` records, for every tensor that a model
forward or a derivative request produced, which derivative-stack entry it
is; ``jacobian`` looks the tensor up and returns the requested component.

Components come from the model's fused Taylor-jet forward
(``_DerivStack.jet_fn``), which serves every multi-index of order <= 2 in
one pass (``precompute``). The nested-jvp path of the JAX package, which
serves higher orders, models without a jet forward and derivatives of
composed expressions, is not ported yet: such a request raises
``NotImplementedError``.
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
    "unwrap",
    "wrap_tape_outputs",
]

_NESTED_JVP = (
    "the nested-jvp derivative path (order > 2, models without a jet "
    "forward, derivatives of composed expressions) is not ported to "
    "paddlescience_torch yet; it comes with a later slice"
)


class _DerivStack:
    """Derivative components of one model over a point batch.

    ``x``: (N, d) coordinates; ``jet_fn(x, dmultis) -> {dmulti: (N, m)}``
    is the model's fused jet forward, or None.
    """

    def __init__(
        self,
        x: torch.Tensor,
        key_index: Dict[str, int],
        out_index: Dict[str, int],
        jet_fn: Optional[Callable] = None,
        out_width: Optional[int] = None,
    ):
        self.x = x
        self.key_index = key_index  # coordinate key -> input column
        self.out_index = out_index  # output key -> output column
        self.jet_fn = jet_fn
        self.requested: Dict[Tuple[int, ...], None] = {}  # ordered set
        self.collect_only = False  # request-collection replay
        if out_width is None:
            out_width = max(out_index.values()) + 1 if out_index else 1
        self.out_width = out_width
        self._components: Dict[Tuple[int, ...], torch.Tensor] = {}

    def get_component(self, dmulti: Tuple[int, ...]) -> torch.Tensor:
        """d^k f / dx_{i1}..dx_{ik} as (N, m). Mixed partials commute, so the
        multi-index is sorted."""
        dmulti = tuple(sorted(dmulti))
        self.requested[dmulti] = None
        if self.collect_only:
            return self.x.new_zeros(self.x.shape[:-1] + (self.out_width,))
        if dmulti not in self._components:
            if self.jet_fn is None or not 0 < len(dmulti) <= 2:
                raise NotImplementedError(
                    f"derivative component {dmulti} cannot be served by the jet "
                    f"forward: {_NESTED_JVP}"
                )
            self._components.update(self.jet_fn(self.x, [dmulti]))
        return self._components[dmulti]

    def precompute(self, dmultis) -> None:
        """Fill the component cache for all order <= 2 requests in one fused
        Taylor-jet forward."""
        if self.jet_fn is None:
            return
        eligible = [m for m in dmultis if 0 < len(m) <= 2 and m not in self._components]
        if eligible:
            self._components.update(self.jet_fn(self.x, eligible))


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

    def add_stack(self, x, key_index, out_index, jet_fn=None, out_width=None) -> _DerivStack:
        stack = _DerivStack(x, key_index, out_index, jet_fn=jet_fn, out_width=out_width)
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

    def derivative(self, rec: _Record, j: int) -> torch.Tensor:
        dmulti = rec.dmulti + (j,)
        comp = rec.stack.get_component(dmulti)
        out = comp[..., rec.out_col : rec.out_col + 1]
        self.register_output(out, rec.stack, rec.out_col, dmulti)
        return out


class TapeArray:
    """A batched tensor tied to the derivative stack it came from.

    A TapeArray around a registered tensor (a model output, a coordinate or
    a derivative) can be differentiated further through the tape. Arithmetic
    on TapeArrays yields a *composed* TapeArray: its value is exact, but
    differentiating it needs the nested-jvp path, so ``jacobian`` of one
    raises ``NotImplementedError``.
    """

    __slots__ = ("value", "stack")

    def __init__(self, value: torch.Tensor, stack: _DerivStack):
        self.value = value
        self.stack = stack

    def __repr__(self):
        return f"TapeArray({self.value!r})"

    def _binop(self, other, op, reflected=False):
        a, b = self.value, unwrap(other)
        res = op(b, a) if reflected else op(a, b)
        same_stack = not isinstance(other, TapeArray) or other.stack is self.stack
        return TapeArray(res, self.stack) if same_stack else res

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
        return self._binop(e, lambda a, b: a**b)

    def __neg__(self):
        return TapeArray(-self.value, self.stack)


def unwrap(v):
    """TapeArray -> its tensor; anything else passes through."""
    return v.value if isinstance(v, TapeArray) else v


def wrap_tape_outputs(tape: Tape, out: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """TapeArray view of an ``out`` dict from ``forward_with_derivatives``:
    model outputs, and the coordinate columns when there is one stack."""
    single = tape._stacks[0] if len(tape._stacks) == 1 else None
    wrapped: Dict[str, object] = {}
    for k, v in out.items():
        rec = tape.lookup(v)
        name = tape.coord_name(v)
        if rec is not None and rec.dmulti == ():
            wrapped[k] = TapeArray(v, rec.stack)
        elif name is not None and single is not None and name in single.key_index:
            wrapped[k] = TapeArray(v, single)
        else:
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
            "No active autodiff tape. `jacobian` on tensors only works inside "
            "constraint/equation evaluation (the expression evaluator opens a tape)."
        )
    return tape


def _resolve_input_col(tape: Tape, rec: _Record, xs, j: Optional[int]) -> int:
    name = tape.coord_name(xs)
    if name is not None:
        if name not in rec.stack.key_index:
            raise ValueError(f"coordinate '{name}' is not an input of the differentiated model")
        return rec.stack.key_index[name]
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
    ``jacobian(jacobian(u, x), x)`` resolves to the (x, x) jet component."""
    tape = _require_tape()
    if isinstance(xs, (list, tuple)):
        return [jacobian(ys, x, i, j) for x in xs]
    wrap_result = isinstance(ys, TapeArray)
    ys = unwrap(ys)
    xs = unwrap(xs)
    rec = tape.lookup(ys)
    if rec is None:
        if wrap_result:
            raise NotImplementedError(
                f"jacobian of a composed expression: {_NESTED_JVP}"
            )
        raise ValueError(
            "ys is not on the autodiff tape; differentiate model outputs or "
            "derivatives thereof (tensors produced inside equation evaluation)"
        )
    col = _resolve_input_col(tape, rec, xs, j)
    out = tape.derivative(_Record(rec.stack, rec.out_col + i, rec.dmulti), col)
    return TapeArray(out, rec.stack) if wrap_result else out
