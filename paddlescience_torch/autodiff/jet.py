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

from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = [
    "Jet",
    "JetIndex",
    "build_index",
    "seed",
    "linear",
    "elementwise",
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
            e[m[0]] = 1.0
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


def _tanh_rule(p):
    t = torch.tanh(p)
    sp = 1.0 - t * t
    return t, sp, -2.0 * t * sp


def _sin_rule(p):
    s, c = torch.sin(p), torch.cos(p)
    return s, c, -s


def _cos_rule(p):
    s, c = torch.sin(p), torch.cos(p)
    return c, -s, -c


def _exp_rule(p):
    e = torch.exp(p)
    return e, e, e


# closed-form (f, f', f'') rules keyed by function identity: one
# transcendental, every derivative a product of the shared primal value
_ELEMENTWISE_RULES = {
    torch.tanh: _tanh_rule,
    torch.sin: _sin_rule,
    torch.cos: _cos_rule,
    torch.exp: _exp_rule,
}


def elementwise(jet: Jet, fn: Callable) -> Jet:
    """Jet chain rule through ``fn``, one of ``torch.tanh``/``sin``/``cos``/
    ``exp``, whose closed-form rule gives sigma' and sigma'' from one
    transcendental. (The JAX package also takes any function through
    ``jax.jvp``; no ported arch needs that.)
    """
    rule = _ELEMENTWISE_RULES.get(fn)
    if rule is None:
        raise ValueError(f"no closed-form jet rule for {fn}; available: tanh, sin, cos, exp")
    idx = jet.index
    f0, sp, spp = rule(jet.streams[0])
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
