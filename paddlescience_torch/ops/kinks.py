"""The relu family's kinks: an either-side check of the jet kernels against
their plain versions.

Where a pre-activation lies within float32 rounding of a point at which
the activation's derivative jumps (relu, relu6, elu, selu, leaky relu), a
kernel and the plain version can rightly take different sides: they sum
the same products in another order. :func:`kink_aware_close` holds a
kernel's outputs to the plain version's within ``rtol`` times the largest
magnitude of each reference tensor on every row without such a
pre-activation, and each row with one (at most ``MAX_KINK_SHARE`` of the
pre-activations, at most 6 in a row) to the float64 plain rule with those
pre-activations set just to one side of their kink or the other, in some
combination. Rows are independent through a layer program, so a flip
moves its own row only. For an activation without kinks the check is the
plain comparison.

One float64 model, :func:`program_rows`, runs any layer program of
``ops/jet_gated.py`` (the MLP segment is ``mlp_program(L)``: every layer
a stage, no gates); the backward's cotangents come from
``torch.autograd`` through it, the stages restarted from the given
boundaries as the backward kernels restart them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from paddlescience_torch.autodiff import jet as jetmod
from paddlescience_torch.ops.jet_gated import GATE, RESIDUAL, STAGE
from paddlescience_torch.ops.jet_mlp import act_jet, index_tables

__all__ = ["KINKS", "KINK_C", "MAX_KINK_SHARE", "program_rows", "kink_elements", "one_sided",
           "kink_aware_close", "kink_rows", "zero_rows"]

# the relu family: activations whose derivatives jump, at these pre-activations
KINKS = {jetmod.RELU: (0.0,), jetmod.RELU6: (0.0, 6.0), jetmod.ELU: (0.0,), jetmod.SELU: (0.0,),
         jetmod.LEAKY_RELU: (0.0,)}
KINK_C = 8  # a float32 pre-activation is within KINK_C * eps32 * (sum |x w| + |b|) of its float64 value
EPS32 = float(torch.finfo(torch.float32).eps)
MAX_KINK_SHARE = 1e-3  # at most this share of the pre-activations may lie that close to a kink

Sides = Dict[Tuple[int, int], int]


def _f64(ts) -> List[torch.Tensor]:
    return [t.detach().double().cpu() for t in ts]


def _nearest_kink(act, value: float) -> float:
    return min(KINKS[act[0]], key=lambda k: abs(value - k))


def program_rows(y, u, v, ws, bs, alphas, program, index, act, sides: Optional[Sides] = None,
                 stage_ins: Optional[Sequence[Sequence[torch.Tensor]]] = None):
    """The layer program in float64 on the given rows: ``y``/``u``/``v``
    lists of S (n, .) streams, ``sides[(layer, column)] = +-1`` sets that
    primal pre-activation of row 0 just above or below its nearest kink
    (differentiably: its cotangent passes through). With ``stage_ins``
    (every stage's input, the first being ``y``) each stage restarts from
    its given input while the cotangent flows on to the stage before, as
    in the backward kernels. Returns (output streams, the carry entering
    every stage but the first, per layer the S pre-activations and the S
    layer inputs)."""
    tables = index_tables(index)
    cur = jetmod.Jet(list(y), index)
    jv = jd = None
    if u:
        jv = jetmod.Jet(list(v), index)
        jd = jetmod.sub(jetmod.Jet(list(u), index), jv)
    bounds, zs, ins = [], [], []
    stage, a, stage_in = 0, 0, None
    for l, op in enumerate(program):
        if op & STAGE:
            if l > 0:
                bounds.append(list(cur.streams))
                stage += 1
                if stage_ins is not None:
                    cur = jetmod.Jet([c + (b - c).detach() for c, b in zip(cur.streams, stage_ins[stage])], index)
            stage_in = cur
        ins.append(list(cur.streams))
        z = [s @ ws[l] for s in cur.streams]
        z[0] = z[0] + bs[l]
        for (ll, c), side in (sides or {}).items():
            if ll == l:
                k = _nearest_kink(act, float(z[0][0, c].detach()))
                target = k + side * 1e-12 * max(1.0, abs(k))
                mask = torch.zeros_like(z[0])
                mask[0, c] = 1.0
                z[0] = z[0] + (target - z[0]).detach() * mask
        zs.append(z)
        nxt = jetmod.Jet(act_jet(z, tables, act), index)
        if op & GATE:
            nxt = jetmod.add(jv, jetmod.mul(nxt, jd))
        if op & RESIDUAL:
            alpha, a = alphas[a], a + 1
            nxt = jetmod.add(jetmod.scale_const(nxt, alpha), jetmod.scale_const(stage_in, 1 - alpha))
        cur = nxt
    return list(cur.streams), bounds, zs, ins


def kink_elements(zs, ins, ws, bs, act) -> List[set]:
    """Per layer, the (row, column) primal pre-activations within KINK_C
    eps32 (sum |x w| + |b|) of a kink of ``act`` (float64 ``zs`` and the
    layer inputs ``ins`` of :func:`program_rows`)."""
    out = []
    for l, (w, b) in enumerate(zip(ws, bs)):
        bound = KINK_C * EPS32 * (ins[l][0].abs() @ w.abs() + b.abs())
        near = torch.zeros_like(zs[l][0], dtype=torch.bool)
        for k in KINKS[act[0]]:
            near |= (zs[l][0] - k).abs() <= bound
        out.append({(int(n), int(c)) for n, c in near.nonzero().tolist()})
    return out


def one_sided(case, program, index, act, row: int, sides: Sides, backward: bool):
    """Float64 results of one row with ``sides`` forced: forward (``case``'s
    y, u, v chained) -> {"out": S, "bound": stages x S}; backward (the
    stages restarted from ``case["bounds"]``, cotangents ``case["g_out"]``
    by autograd) -> {"g_y", "g_u", "g_v": S each, "gz", "in": layers x S},
    each tensor of one row."""
    pick = lambda ts: [t[row : row + 1].detach().double().cpu() for t in ts]
    ws, bs, alphas = _f64(case["ws"]), _f64(case["bs"]), _f64(case["alphas"])
    y, u, v = pick(case["y"]), pick(case["u"]), pick(case["v"])
    if not backward:
        out, bounds, _, _ = program_rows(y, u, v, ws, bs, alphas, program, index, act, sides)
        return {"out": out, "bound": bounds}
    leaves = [t.requires_grad_() for t in (*y, *u, *v)]
    stage_ins = [y] + [pick(b.unbind(0)) for b in case["bounds"]]
    with torch.enable_grad():
        out, _, zs, ins = program_rows(y, u, v, ws, bs, alphas, program, index, act, sides, stage_ins)
        flat_z = [z for layer in zs for z in layer]
        total = sum((o * g).sum() for o, g in zip(out, pick(case["g_out"])))
        grads = torch.autograd.grad(total, [*leaves, *flat_z], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, [*leaves, *flat_z])]
    S = len(y)
    n_u = len(u)
    gz = [grads[S + 2 * n_u + l * S : S + 2 * n_u + (l + 1) * S] for l in range(len(zs))]
    return {"g_y": grads[:S], "g_u": grads[S : S + n_u], "g_v": grads[S + n_u : S + 2 * n_u], "gz": gz,
            "in": [[t.detach() for t in layer] for layer in ins]}


_FWD = ("out", "bound")


def _pairs(got, ref) -> List[tuple]:
    """(kernel tensor, plain tensor, side, key, index...) per (N, .) tensor
    of the outputs named in ``got``: "out", "g_y", "g_u", "g_v" lists of S;
    "bound", "gz" and "in" per stage or layer, S streams each (a stacked
    (S, N, D) tensor or a list)."""
    out = []
    for key, val in got.items():
        if key in ("out", "g_y", "g_u", "g_v"):
            out += [(g, r, key, s) for s, (g, r) in enumerate(zip(val, ref[key]))]
        else:
            for l, (gl, rl) in enumerate(zip(val, ref[key])):
                out += [(gl[s], rl[s], key, l, s) for s in range(len(gl))]
    return out


def _kinks(case, program, index, act) -> Dict[str, List[set]]:
    """Per side ("fwd": chained from the inputs; "bwd": each stage from
    its given boundary), per layer, the pre-activations at a kink."""
    ws, bs, alphas = _f64(case["ws"]), _f64(case["bs"]), _f64(case["alphas"])
    y, u, v = _f64(case["y"]), _f64(case["u"]), _f64(case["v"])
    stage_ins = [y] + [_f64(b.unbind(0)) for b in case["bounds"]]
    with torch.no_grad():
        _, _, zs, ins = program_rows(y, u, v, ws, bs, alphas, program, index, act)
        fwd = kink_elements(zs, ins, ws, bs, act)
        _, _, zs, ins = program_rows(y, u, v, ws, bs, alphas, program, index, act, stage_ins=stage_ins)
        return {"fwd": fwd, "bwd": kink_elements(zs, ins, ws, bs, act)}


def kink_rows(case, program, index, act) -> List[int]:
    """The rows with a pre-activation at a kink, forward or backward (none
    for an activation without kinks)."""
    if act[0] not in KINKS:
        return []
    return sorted({n for side in _kinks(case, program, index, act).values() for e in side for n, _ in e})


def zero_rows(ts, rows: Sequence[int]) -> List[torch.Tensor]:
    """Copies of ``ts`` with ``rows`` set to 0: output cotangents that are 0
    on the kink rows make every backward output, and every sum over rows
    of them, independent of the side a kink takes."""
    out = [t.clone() for t in ts]
    for t in out:
        t[list(rows)] = 0
    return out


def kink_aware_close(case, got, ref, program, index, act, rtol: float) -> None:
    """Hold the kernels' outputs ``got`` against the plain version's ``ref``
    (dicts of the outputs named in :func:`_pairs`; forward ones go by the
    forward's kinks, chained from ``case``'s inputs, backward ones by the
    backward's, restarted from ``case["bounds"]``). ``case``: y, u, v, ws,
    bs, alphas, g_out (the output cotangents) and bounds (the plain
    forward's stage boundaries, (S, N, D) each). Raises AssertionError."""
    pairs = _pairs(got, ref)

    def close(g, r, scale):
        err = float((g - r).abs().max()) if g.numel() else 0.0
        assert err <= rtol * max(scale, 1e-30), f"max abs err {err:.3e} > {rtol} * {scale:.3e}"

    if act[0] not in KINKS:
        for g, r, *_ in pairs:
            close(g.detach().cpu(), r.detach().cpu(), float(r.abs().max()))
        return
    kinks = _kinks(case, program, index, act)
    n_pre = case["y"][0].shape[0] * sum(int(w.shape[1]) for w in case["ws"])
    for side in ("fwd", "bwd"):
        count = sum(len(e) for e in kinks[side])
        assert count <= MAX_KINK_SHARE * n_pre, f"{count} of {n_pre} pre-activations at a kink ({side})"
    rows = {side: sorted({n for e in kinks[side] for n, _ in e}) for side in kinks}
    side_of = lambda key: "fwd" if key in _FWD else "bwd"
    for g, r, key, *_ in pairs:
        g, r = g.detach().cpu(), r.detach().cpu()
        keep = torch.ones(g.shape[0], dtype=torch.bool)
        keep[rows[side_of(key)]] = False
        close(g[keep], r[keep], float(r.abs().max()))
    for side in ("fwd", "bwd"):
        row_pairs = [p for p in pairs if side_of(p[2]) == side]
        for n in rows[side]:
            elems = [(l, c) for l, e in enumerate(kinks[side]) for m, c in e if m == n]
            assert len(elems) <= 6, f"row {n}: {len(elems)} pre-activations at a kink"
            ok = False
            for combo in range(2 ** len(elems)):
                sides = {e: (1 if combo >> i & 1 else -1) for i, e in enumerate(elems)}
                res = one_sided(case, program, index, act, n, sides, backward=side == "bwd")
                if all(float((g.detach().cpu()[n].double() - _at(res, key, idx)[0]).abs().max())
                       <= rtol * max(float(r.abs().max()), 1e-30) for g, r, key, *idx in row_pairs):
                    ok = True
                    break
            assert ok, f"row {n}: the kernel's {side} values match neither side of its kinks {elems}"


def _at(res, key, idx):
    val = res[key]
    for i in idx:
        val = val[i]
    return val
