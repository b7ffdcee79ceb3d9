"""Batched multivariate Taylor-jet forward (counterpart of
``paddlescience_tpu/autodiff/jet.py``).

Every intermediate is a :class:`Jet`: a tuple of ``(N, w)`` stream tensors
(stream 0 = primal) named by a :class:`JetIndex`, e.g.
``((), (0,), (1,), (1, 1))`` for ``u, u_t, u_x, u_xx``. Nonlinearities
apply the closed-form chain rule

    sigma(f)_i  = sigma'(f) f_i
    sigma(f)_ij = sigma''(f) f_i f_j + sigma'(f) f_ij

with sigma' and sigma'' evaluated once on the primal stream, so all
requested derivative components of order <= 2 come out of one forward pass
that autograd can differentiate with respect to the weights.

Linear layers run one ``(N, in) @ (in, out)`` product per stream (the JAX
package's "split" mode; its "fused" concat mode is an XLA fusion workaround
with no counterpart here).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "Jet",
    "JetIndex",
    "build_index",
    "seed",
    "linear",
    "elementwise",
    "act_of",
    "act_derivs",
    "ACT_RULES",
    "ACT_NAMES",
    "mul",
    "add",
    "sub",
    "scale_const",
    "concat",
    "split",
]

Multi = Tuple[int, ...]


class JetIndex:
    """Ordered set of derivative multi-indices carried by a Jet.

    ``multis[0]`` is always ``()`` (the primal). Singletons precede pairs, and
    every pair's singletons are present (closure, which the chain rule needs).
    """

    __slots__ = ("multis", "pos", "singles", "pairs")

    def __init__(self, multis: Sequence[Multi]):
        multis = tuple(tuple(sorted(m)) for m in multis)
        if not multis or multis[0] != ():
            raise ValueError("JetIndex must start with the primal ()")
        self.multis = multis
        self.pos: Dict[Multi, int] = {m: i for i, m in enumerate(multis)}
        self.singles: Tuple[Multi, ...] = tuple(m for m in multis if len(m) == 1)
        self.pairs: Tuple[Multi, ...] = tuple(m for m in multis if len(m) == 2)
        if any(len(m) > 2 for m in multis):
            raise ValueError(f"jet supports orders <= 2, got {multis}")
        for (i, j) in self.pairs:
            if (i,) not in self.pos or (j,) not in self.pos:
                raise ValueError(
                    f"pair ({i},{j}) requires singleton streams ({i},) and ({j},)"
                )

    def __len__(self):
        return len(self.multis)

    def __eq__(self, other):
        return isinstance(other, JetIndex) and self.multis == other.multis

    def __hash__(self):
        return hash(self.multis)

    def __repr__(self):
        return f"JetIndex({self.multis})"


def build_index(dmultis: Sequence[Multi]) -> JetIndex:
    """Close a set of requested components over primal + singleton streams."""
    singles: List[Multi] = []
    pairs: List[Multi] = []
    seen = set()
    for m in dmultis:
        m = tuple(sorted(m))
        if m in seen or m == ():
            continue
        seen.add(m)
        if len(m) == 1:
            singles.append(m)
        elif len(m) == 2:
            pairs.append(m)
        else:
            raise ValueError(f"jet supports orders <= 2, got {m}")
    for (i, j) in pairs:
        for s in ((i,), (j,)):
            if s not in seen:
                seen.add(s)
                singles.append(s)
    return JetIndex([()] + sorted(singles) + sorted(pairs))


class Jet:
    """``streams``: tuple of (..., w) tensors aligned with ``index.multis``."""

    __slots__ = ("streams", "index")

    def __init__(self, streams: Sequence[torch.Tensor], index: JetIndex):
        streams = tuple(streams)
        if len(streams) != len(index):
            raise ValueError(f"{len(streams)} streams != index size {len(index)}")
        self.streams = streams
        self.index = index

    def component(self, dmulti: Multi) -> torch.Tensor:
        return self.streams[self.index.pos[tuple(sorted(dmulti))]]

    def __repr__(self):
        return f"Jet(streams={self.index.multis}, shape={tuple(self.streams[0].shape)})"


def seed(x: torch.Tensor, index: JetIndex) -> Jet:
    """Seed the coordinate jet: primal = x (N, d); singleton (i,) = e_i;
    pairs = 0 (coordinates are affine in themselves)."""
    d = x.shape[-1]
    streams = [x]
    for m in index.multis[1:]:
        if len(m) == 1:
            e = x.new_zeros((d,))
            e[m[0]].fill_(1.0)  # a kernel, no host copy: the seed runs inside captured steps
            streams.append(e.expand_as(x))
        else:
            streams.append(torch.zeros_like(x))
    return Jet(streams, index)


def linear(jet: Jet, w: torch.Tensor, b=None) -> Jet:
    """Linear layer on every stream (``x @ W``, W of shape (in, out)); bias
    on the primal only."""
    outs = [s @ w for s in jet.streams]
    if b is not None:
        outs[0] = outs[0] + b
    return Jet(outs, jet.index)


# ---------------------------------------------------- activation rules --
#
# Closed-form (f, f', f'', f''') of every activation the fused segments
# take, keyed by an integer id and one float parameter (Siren's w0). The
# same table, by the same ids, is ``psci_act`` in csrc/jet_common.cuh: the
# jet rule needs f, f', f''; the hand-derived VJP of the rule f', f'',
# f'''. At a kink the derivative is the one JAX's ``jvp`` of ``jax.nn``
# gives: relu and relu6 take 0 at 0 (and relu6 at 6), elu and selu their
# left branch at 0, leaky_relu its right branch.

TANH, IDENTITY, SIN, COS, EXP, SIGMOID, SILU, SOFTPLUS, MISH, GELU, RELU, RELU6, ELU, SELU, LEAKY_RELU, SIREN = range(16)
ACT_NAMES = ("tanh", "identity", "sin", "cos", "exp", "sigmoid", "silu", "softplus", "mish", "gelu", "relu",
             "relu6", "elu", "selu", "leaky_relu", "siren")
SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
LEAKY_SLOPE = 0.01
GELU_K = 0.7978845608028654  # sqrt(2 / pi)
GELU_C = 0.044715

Act = Tuple[int, float]  # (activation id, parameter)


def _sigmoid4(x):
    s = torch.sigmoid(x)
    s1 = s * (1 - s)
    return s, s1, s1 * (1 - 2 * s), s1 * (1 - 6 * s + 6 * s * s)


def _tanh4(x, w):
    t = torch.tanh(x)
    sp = 1.0 - t * t
    return t, sp, -2.0 * t * sp, -2.0 * sp * sp + 4.0 * t * t * sp


def _sin4(x, w):
    s, c = torch.sin(x), torch.cos(x)
    return s, c, -s, -c


def _cos4(x, w):
    s, c = torch.sin(x), torch.cos(x)
    return c, -s, -c, s


def _exp4(x, w):
    e = torch.exp(x)
    return e, e, e, e


def _identity4(x, w):
    zero = torch.zeros_like(x)
    return x, torch.ones_like(x), zero, zero


def _silu4(x, w):
    s, s1, s2, s3 = _sigmoid4(x)
    return x * s, s + x * s1, 2 * s1 + x * s2, 3 * s2 + x * s3


def _softplus4(x, w):
    s, s1, s2, _ = _sigmoid4(x)
    return torch.logaddexp(x, torch.zeros_like(x)), s, s1, s2


def _mish4(x, w):
    s, s1, s2, _ = _sigmoid4(x)
    g = torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))  # tanh(softplus x)
    h = 1 - g * g
    g1 = h * s
    h1 = -2 * g * g1
    g2 = h1 * s + h * s1
    h2 = -2 * (g1 * g1 + g * g2)
    g3 = h2 * s + 2 * h1 * s1 + h * s2
    return x * g, g + x * g1, 2 * g1 + x * g2, 3 * g2 + x * g3


def _gelu4(x, w):
    """The tanh approximation, ``jax.nn.gelu``'s default."""
    u1 = GELU_K * (1 + 3 * GELU_C * x * x)
    u2 = 6 * GELU_K * GELU_C * x
    t = torch.tanh(GELU_K * (x + GELU_C * x * x * x))
    s = 1 - t * t
    t1 = s * u1
    t2 = -2 * t * t1 * u1 + s * u2
    t3 = -2 * (t1 * t1 * u1 + t * t2 * u1 + 2 * t * t1 * u2) + s * (6 * GELU_K * GELU_C)
    return 0.5 * x * (1 + t), 0.5 * (1 + t) + 0.5 * x * t1, t1 + 0.5 * x * t2, 1.5 * t2 + 0.5 * x * t3


def _linear_pieces4(f, f1):
    zero = torch.zeros_like(f)
    return f, f1, zero, zero


def _relu4(x, w):
    pos = x > 0
    return _linear_pieces4(torch.where(pos, x, torch.zeros_like(x)), pos.to(x.dtype))


def _relu64(x, w):
    return _linear_pieces4(torch.clamp(x, 0.0, 6.0), ((x > 0) & (x < 6)).to(x.dtype))


def _leaky4(x, w):
    pos = x >= 0
    return _linear_pieces4(torch.where(pos, x, LEAKY_SLOPE * x),
                           torch.where(pos, torch.ones_like(x), torch.full_like(x, LEAKY_SLOPE)))


def _elu4(x, alpha, scale):
    pos = x > 0
    xn = torch.where(pos, torch.zeros_like(x), x)
    e = (scale * alpha) * torch.exp(xn)
    zero = torch.zeros_like(x)
    f = torch.where(pos, scale * x, (scale * alpha) * torch.expm1(xn))
    return f, torch.where(pos, torch.full_like(x, scale), e), torch.where(pos, zero, e), torch.where(pos, zero, e)


def _siren4(x, w):
    s, c = torch.sin(w * x), torch.cos(w * x)
    return s, w * c, -w * w * s, -w * w * w * c


ACT_RULES: Dict[int, Callable] = {
    TANH: _tanh4,
    IDENTITY: _identity4,
    SIN: _sin4,
    COS: _cos4,
    EXP: _exp4,
    SIGMOID: lambda x, w: _sigmoid4(x),
    SILU: _silu4,
    SOFTPLUS: _softplus4,
    MISH: _mish4,
    GELU: _gelu4,
    RELU: _relu4,
    RELU6: _relu64,
    ELU: lambda x, w: _elu4(x, 1.0, 1.0),
    SELU: lambda x, w: _elu4(x, SELU_ALPHA, SELU_SCALE),
    LEAKY_RELU: _leaky4,
    SIREN: _siren4,
}

# plain torch functions with a rule, by identity
_FN_ACTS: Dict[Callable, Act] = {torch.tanh: (TANH, 0.0), torch.sin: (SIN, 0.0), torch.cos: (COS, 0.0),
                                 torch.exp: (EXP, 0.0)}


def act_of(fn) -> Optional[Act]:
    """The (id, parameter) of ``fn``'s closed-form rule: an activation of
    ``arch/activation.py`` carries its own (``jet_act``); of the plain torch
    functions tanh, sin, cos and exp have one. None for anything else."""
    act = getattr(fn, "jet_act", None)
    if act is not None:
        return act
    return _FN_ACTS.get(fn) if getattr(fn, "__hash__", None) else None


def act_derivs(act: Act, x: torch.Tensor):
    """(f, f', f'', f''') of activation ``act`` at ``x``."""
    return ACT_RULES[act[0]](x, act[1])


def elementwise(jet: Jet, fn: Callable) -> Jet:
    """Jet chain rule through ``fn``: an activation of
    ``arch/activation.py`` or ``torch.tanh``/``sin``/``cos``/``exp``, whose
    closed-form rule gives sigma' and sigma'' (:func:`act_derivs`), or a
    parametric one (``Stan``, ``Swish``) whose ``jet_derivs(x)`` gives
    them from its parameters. (The JAX package also takes any other
    function through ``jax.jvp``; no ported arch needs that.)
    """
    idx = jet.index
    if hasattr(fn, "jet_derivs"):
        f0, sp, spp = fn.jet_derivs(jet.streams[0])
    else:
        act = act_of(fn)
        if act is None:
            raise ValueError(f"no closed-form jet rule for {fn}; available: the activations of "
                             "arch/activation.py and torch.tanh, sin, cos, exp")
        f0, sp, spp, _ = act_derivs(act, jet.streams[0])
    streams = [f0]
    for m in idx.multis[1:]:
        if len(m) == 1:
            streams.append(sp * jet.streams[idx.pos[m]])
        else:
            i, j = m
            fi = jet.streams[idx.pos[(i,)]]
            fj = jet.streams[idx.pos[(j,)]]
            streams.append(spp * fi * fj + sp * jet.streams[idx.pos[m]])
    return Jet(streams, idx)


def mul(a: Jet, b: Jet) -> Jet:
    """Hadamard product rule."""
    idx = a.index
    if b.index != idx:
        raise ValueError("jet product requires matching indices")
    sa, sb = a.streams, b.streams
    streams = [sa[0] * sb[0]]
    for m in idx.multis[1:]:
        k = idx.pos[m]
        if len(m) == 1:
            streams.append(sa[k] * sb[0] + sa[0] * sb[k])
        else:
            i, j = m
            ai, aj = sa[idx.pos[(i,)]], sa[idx.pos[(j,)]]
            bi, bj = sb[idx.pos[(i,)]], sb[idx.pos[(j,)]]
            streams.append(sa[k] * sb[0] + sa[0] * sb[k] + ai * bj + aj * bi)
    return Jet(streams, idx)


def add(a: Jet, b: Jet) -> Jet:
    if b.index != a.index:
        raise ValueError("jet add requires matching indices")
    return Jet([x + y for x, y in zip(a.streams, b.streams)], a.index)


def sub(a: Jet, b: Jet) -> Jet:
    if b.index != a.index:
        raise ValueError("jet sub requires matching indices")
    return Jet([x - y for x, y in zip(a.streams, b.streams)], a.index)


def scale_const(jet: Jet, c) -> Jet:
    """Multiply by a value constant w.r.t. the coordinates: every stream
    scales."""
    return Jet([s * c for s in jet.streams], jet.index)


def concat(jets: Sequence[Jet], axis: int = -1) -> Jet:
    idx = jets[0].index
    for j in jets[1:]:
        if j.index != idx:
            raise ValueError("jet concat requires matching indices")
    return Jet(
        [torch.cat([j.streams[k] for j in jets], dim=axis) for k in range(len(idx))],
        idx,
    )


def split(jet: Jet, widths: Sequence[int]) -> List[Jet]:
    out, ofs = [], 0
    for w in widths:
        out.append(Jet([s[..., ofs : ofs + w] for s in jet.streams], jet.index))
        ofs += w
    return out
