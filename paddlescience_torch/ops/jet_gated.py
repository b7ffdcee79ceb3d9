"""Fused Taylor-jet segments of the gated stacks (ModifiedMLP, PirateNet):
hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``paddlescience_tpu/ops/jet_pallas.py`` for the bodies that
``arch/mlp.py`` feeds it besides the ungated MLP (``ops/jet_mlp.py``): the
gated ModifiedMLP segment (``_mlp_segment_fn(gated=True)``) and the
PirateNet block group (``_piratenet_blocks_fn``). One *layer program*
expresses all of them. A segment is L ``linear + activation`` layers on
the S streams of the carry ``y`` (one activation of
``autodiff/jet.py::ACT_RULES`` for the whole segment, ``act = (id,
parameter)``, default tanh; widths <= 256); each layer's op code says what
follows it:

* ``GATE``     - the two-stream gate ``v + y * (u - v)`` (the jet product
  rule) with the segment's gate jets ``u`` and ``v``;
* ``RESIDUAL`` - the adaptive residual ``alpha * y + (1 - alpha) * y_in``
  with ``y_in`` the carry that entered the layer's stage;
* ``STAGE``    - the layer starts a stage. Stage inputs are the boundaries
  the forward can save and the backward restarts from; a stage's inner
  layer inputs are recomputed in the backward.

``mlp_program`` (no gates), ``modified_mlp_program`` (a gate after every
layer, one layer per stage) and ``piratenet_program`` (per block: gates
after layers 1 and 2, the residual after layer 3, one block per stage)
build the three bodies.

* :func:`jet_gated_fwd` (``csrc/jet_gated_fwd.cu``) replaces ``_forward``
  (``jet_pallas.py:361``) for these bodies;
* :func:`jet_gated_bwd` (``csrc/jet_gated_bwd.cu``) replaces the per-tile
  part of ``_bwd`` (``jet_pallas.py:557``, ``_staged_vjp``): cotangents of
  the ``y``, ``u`` and ``v`` streams, every layer's ``gz`` and input, and
  per-tile partial sums of d alpha, all for ``ops/jet_mlp.py::jet_wgrad``,
  which sums dW, db and d alpha over the batch in one launch, in a fixed
  order.

:class:`_JetGatedSegment` wraps them, with ``jet_wgrad``, in one
``torch.autograd.Function``. Wrappers take their plain versions for CPU
tensors only; on CUDA tensors they launch or raise. Counters as in
``ops/jet_mlp.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from paddlescience_torch.autodiff import jet as jetmod
from paddlescience_torch.ops import cuda_build, jet_mlp
from paddlescience_torch.ops.cuda_build import F, I, P, ints, is_cpu, launch, on_device, ptrs, stream_handle
from paddlescience_torch.ops.jet_mlp import (BM, TANH, act_args, act_jet, act_jet_vjp, index_tables,
                                             jet_alpha_reduce_plain)

__all__ = [
    "GATE",
    "RESIDUAL",
    "STAGE",
    "mlp_program",
    "modified_mlp_program",
    "piratenet_program",
    "jet_gated_fwd",
    "jet_gated_bwd",
    "jet_gated_fwd_plain",
    "jet_gated_bwd_plain",
    "jet_alpha_reduce_plain",
    "jet_gated_segment",
    "reset_counters",
]

GATE, RESIDUAL, STAGE = 1, 2, 4  # op-code bits of a layer (csrc/jet_common.cuh)

Program = Tuple[int, ...]
Tensors = Tuple[torch.Tensor, ...]


def mlp_program(n_layers: int) -> Program:
    return (STAGE,) * n_layers


def modified_mlp_program(n_layers: int) -> Program:
    return (STAGE | GATE,) * n_layers


def piratenet_program(n_blocks: int) -> Program:
    return (STAGE | GATE, GATE, RESIDUAL) * n_blocks


def _stages(program: Program) -> List[Tuple[int, int]]:
    """(first, last) layer of every stage; validates the program."""
    if not program or not program[0] & STAGE:
        raise ValueError("a layer program starts with a STAGE layer")
    starts = [l for l, op in enumerate(program) if op & STAGE]
    stages = [(a, b - 1) for a, b in zip(starts, starts[1:] + [len(program)])]
    for l, op in enumerate(program):
        if op & RESIDUAL and (op & GATE or all(l != last for _, last in stages)):
            raise ValueError(f"layer {l}: a residual closes its stage and follows no gate")
    return stages


def _n_residuals(program: Program) -> int:
    return sum(1 for op in program if op & RESIDUAL)


def _has_gates(program: Program) -> bool:
    return any(op & GATE for op in program)


# ----------------------------------------------------------- plain versions --


def _layer_fwd(y: jetmod.Jet, w, b, op: int, jv, jd, alpha, stage_in, act) -> jetmod.Jet:
    y = jetmod.Jet(act_jet(jetmod.linear(y, w, b).streams, index_tables(y.index), act), y.index)
    if op & GATE:
        y = jetmod.add(jv, jetmod.mul(y, jd))
    if op & RESIDUAL:
        y = jetmod.add(jetmod.scale_const(y, alpha), jetmod.scale_const(stage_in, 1 - alpha))
    return y


def jet_gated_fwd_plain(y, u, v, weights, biases, alphas, program: Program, index: jetmod.JetIndex,
                        save_bounds: bool = False, act: jetmod.Act = TANH) -> Tuple[Tensors, Tensors]:
    """The layer program in jet primitives. ``u``/``v`` are the gate
    streams (empty when the program has no gate), ``alphas`` one (1,)
    tensor per residual layer in order. Returns the output streams and,
    with ``save_bounds``, the carry entering every stage but the first as
    (S, N, D) tensors."""
    jet_mlp._note_plain_call(jet_gated_fwd_plain, y[0])
    _stages(program)
    cur = jetmod.Jet(y, index)
    jv = jd = stage_in = None
    if _has_gates(program):
        jv = jetmod.Jet(v, index)
        jd = jetmod.sub(jetmod.Jet(u, index), jv)
    bounds, a = [], 0
    for l, op in enumerate(program):
        if op & STAGE:
            if save_bounds and l > 0:
                bounds.append(torch.stack(cur.streams))
            stage_in = cur
        alpha = None
        if op & RESIDUAL:
            alpha, a = alphas[a], a + 1
        cur = _layer_fwd(cur, weights[l], biases[l], op, jv, jd, alpha, stage_in, act)
    return cur.streams, tuple(bounds)


def _mul_vjp(f, d, g, tables):
    """VJP of the jet product p = f * d for cotangents g of p: (g_f, g_d).
    p_0 = f_0 d_0, p_k = f_k d_0 + f_0 d_k,
    p_ij = f_ij d_0 + f_0 d_ij + f_i d_j + f_j d_i."""
    kinds, pa, pb = tables
    S = len(g)
    gf = [g[s] * d[0] for s in range(S)]
    gd = [g[s] * f[0] for s in range(S)]
    gf[0] = sum(g[s] * d[s] for s in range(S))
    gd[0] = sum(g[s] * f[s] for s in range(S))
    for s in range(1, S):
        if kinds[s] == 2:
            a, b = pa[s], pb[s]
            gf[a] = gf[a] + g[s] * d[b]
            gf[b] = gf[b] + g[s] * d[a]
            gd[a] = gd[a] + g[s] * f[b]
            gd[b] = gd[b] + g[s] * f[a]
    return gf, gd


def jet_gated_bwd_plain(y, u, v, bounds, weights, biases, alphas, g_out, program: Program,
                        index: jetmod.JetIndex, act: jetmod.Act = TANH):
    """Hand-derived VJP of the layer program, stage by stage in reverse:
    recompute a stage's inner layer inputs from its boundary, then walk its
    layers backwards through the residual, gate and activation rules.

    Returns ``(g_y, g_u, g_v, gzs, layer_inputs, d_alpha)``: the cotangents
    of the three input jets (``g_u``/``g_v`` empty without gates), per
    layer the pre-activation cotangents (S, N, D) and the S input streams
    (what ``jet_wgrad`` needs), and d alpha as one (n_residuals,) tensor."""
    jet_mlp._note_plain_call(jet_gated_bwd_plain, y[0])
    tables = index_tables(index)
    stages = _stages(program)
    S, L = len(y), len(program)
    stage_ins = [tuple(y)] + [tuple(bd.unbind(0)) for bd in bounds]
    gated = _has_gates(program)
    d = [us - vs for us, vs in zip(u, v)] if gated else None
    gu = [torch.zeros_like(s) for s in u] if gated else []
    gv = [torch.zeros_like(s) for s in v] if gated else []
    g = list(g_out)
    gzs: List[Optional[torch.Tensor]] = [None] * L
    ins: List[Optional[Tensors]] = [None] * L
    d_alpha = []
    a = _n_residuals(program)
    for si in reversed(range(len(stages))):
        l0, l1 = stages[si]
        x = stage_ins[si]
        ins[l0] = x
        for l in range(l0, l1):  # inner layers carry no residual
            z = [s @ weights[l] for s in x]
            z[0] = z[0] + biases[l]
            x = act_jet(z, tables, act)
            if program[l] & GATE:
                x = [vs + ps for vs, ps in zip(v, jetmod.mul(jetmod.Jet(x, index), jetmod.Jet(d, index)).streams)]
            ins[l + 1] = tuple(x)
        g_res = None
        for l in reversed(range(l0, l1 + 1)):
            w, op = weights[l], program[l]
            z = [s @ w for s in ins[l]]
            z[0] = z[0] + biases[l]
            if op & (GATE | RESIDUAL):
                f = act_jet(z, tables, act)
            if op & RESIDUAL:
                a -= 1
                alpha = alphas[a]
                d_alpha.append(sum((gs * (fs - xs)).sum() for gs, fs, xs in zip(g, f, stage_ins[si])))
                g_res = [(1 - alpha) * gs for gs in g]
                g = [alpha * gs for gs in g]
            if op & GATE:
                gf, gd = _mul_vjp(f, d, g, tables)
                for s in range(S):
                    gu[s] = gu[s] + gd[s]
                    gv[s] = gv[s] + g[s] - gd[s]
                g = gf
            gz = act_jet_vjp(z, g, tables, act)
            gzs[l] = torch.stack(gz)
            g = [x @ w.t() for x in gz]
        if g_res is not None:
            g = [gs + rs for gs, rs in zip(g, g_res)]
    d_alpha = torch.stack(d_alpha[::-1]) if d_alpha else y[0].new_zeros(0)
    return tuple(g), tuple(gu), tuple(gv), tuple(gzs), tuple(ins), d_alpha


# ----------------------------------------------------------- CUDA wrappers --

cuda_build.declare("jet_gated_fwd", [P] * 13 + [I] * 5 + [F, P])
cuda_build.declare("jet_gated_bwd", [P] * 18 + [I] * 6 + [F, P])


def _gated_dims(y, u, v, weights, biases, alphas, program, index) -> List[int]:
    _stages(program)
    if len(program) != len(weights):
        raise ValueError(f"the program has {len(program)} layers, got {len(weights)} weights")
    dims = jet_mlp._segment_dims(y, weights, biases, index, gated=True)
    if len(alphas) != _n_residuals(program) or any(tuple(a.shape) != (1,) for a in alphas):
        raise ValueError("need one (1,) alpha per residual layer")
    if _has_gates(program):
        if len(u) != len(y) or len(v) != len(y):
            raise ValueError("the gate jets u, v carry the streams of y")
        wuv = int(u[0].shape[1])
        if any(tuple(s.shape) != tuple(u[0].shape) for s in (*u, *v)) or u[0].shape[0] != y[0].shape[0]:
            raise ValueError("all gate streams share one shape and the batch of y")
        if any(dims[l + 1] != wuv for l, op in enumerate(program) if op & GATE):
            raise ValueError(f"gated layers must have the width {wuv} of the gate streams, got {dims}")
    if _n_residuals(program) and len(set(dims)) != 1:
        raise ValueError(f"a program with residuals needs one width throughout, got {dims}")
    return dims


def _per_layer(program: Program, at_stage_start, inner=None) -> list:
    """A per-layer list for the kernels' pointer tables: entry l is the
    next item of ``at_stage_start`` for a stage's first layer (l > 0), the
    next of ``inner`` otherwise, None where there is none."""
    a, b = iter(at_stage_start or ()), iter(inner or ())
    out = [None]
    for op in program[1:]:
        out.append(next(a, None) if op & STAGE else next(b, None))
    return out


def _alpha_table(program: Program, alphas) -> list:
    it = iter(alphas)
    return [next(it) if op & RESIDUAL else None for op in program]


def jet_gated_fwd(y, u, v, weights, biases, alphas, program: Program, index: jetmod.JetIndex,
                  save_bounds: bool = False, act: jetmod.Act = TANH) -> Tuple[Tensors, Tensors]:
    """Segment forward; returns (output streams, stage boundaries)."""
    if is_cpu(y[0]):
        return jet_gated_fwd_plain(y, u, v, weights, biases, alphas, program, index, save_bounds, act)
    dev = y[0].device
    dims = _gated_dims(y, u, v, weights, biases, alphas, program, index)
    act_id, act_w = act_args(act)
    S, L, N = len(y), len(weights), int(y[0].shape[0])
    y, u, v, weights, biases, alphas = ([on_device(t, dev) for t in ts] for ts in (y, u, v, weights, biases, alphas))
    outs = tuple(torch.empty(N, dims[-1], device=dev) for _ in range(S))
    starts = [l for l, op in enumerate(program) if op & STAGE and l > 0]
    bounds: Tensors = ()
    if save_bounds:
        bounds = tuple(torch.empty(S, N, dims[l], device=dev) for l in starts)
        table = _per_layer(program, bounds)
    elif _n_residuals(program) and starts:
        # a residual reads its stage input back from device memory: without
        # saved boundaries every stage writes it to one shared scratch
        scratch = torch.empty(S, N, dims[0], device=dev)
        table = _per_layer(program, [scratch] * len(starts))
    else:
        table = [None] * L
    kinds, pa, pb = index_tables(index)
    launch("jet_gated_fwd", ptrs(y), ptrs(u) if u else None, ptrs(v) if v else None, ptrs(weights),
           ptrs(biases), ptrs(_alpha_table(program, alphas)), ptrs(outs), ptrs(table), ints(dims),
           ints(program), ints(kinds), ints(pa), ints(pb), S, L, N, jet_mlp.fwd_kst(dims), act_id, act_w,
           stream_handle(dev))
    jet_gated_fwd.launches += 1
    return outs, bounds


def jet_gated_bwd(y, u, v, bounds, weights, biases, alphas, g_out, program: Program,
                  index: jetmod.JetIndex, act: jetmod.Act = TANH):
    """Segment backward from the stage boundaries; returns what
    :func:`jet_gated_bwd_plain` returns, but d alpha as (n_tiles,
    n_residuals) partial sums, the ``alpha_partials`` of ``jet_wgrad`` (one
    tile, the whole sum, on CPU tensors)."""
    if is_cpu(y[0]):
        *rest, d_alpha = jet_gated_bwd_plain(y, u, v, bounds, weights, biases, alphas, g_out, program, index, act)
        return (*rest, d_alpha[None])
    dev = y[0].device
    dims = _gated_dims(y, u, v, weights, biases, alphas, program, index)
    act_id, act_w = act_args(act)
    S, L, N = len(y), len(weights), int(y[0].shape[0])
    starts = [l for l, op in enumerate(program) if op & STAGE and l > 0]
    if len(bounds) != len(starts) or len(g_out) != S:
        raise ValueError(f"jet_gated_bwd: need {len(starts)} boundaries and {S} cotangents")
    kmax = jet_mlp._round4(max(dims))
    y, u, v, bounds, weights, biases, alphas, g_out = (
        [on_device(t, dev) for t in ts] for ts in (y, u, v, bounds, weights, biases, alphas, g_out))
    for bd, l in zip(bounds, starts):
        if tuple(bd.shape) != (S, N, dims[l]):
            raise ValueError(f"jet_gated_bwd: boundary of layer {l} has shape {tuple(bd.shape)}")
    gated, n_res = _has_gates(program), _n_residuals(program)
    g_y = tuple(torch.empty(N, dims[0], device=dev) for _ in range(S))
    g_u = tuple(torch.empty_like(s) for s in u) if gated else ()
    g_v = tuple(torch.empty_like(s) for s in v) if gated else ()
    gzs = tuple(torch.empty(S, N, dims[l + 1], device=dev) for l in range(L))
    inner = [torch.empty(S, N, dims[l], device=dev) for l, op in enumerate(program) if l > 0 and not op & STAGE]
    table = _per_layer(program, bounds, inner)
    n_tiles = -(-N // BM)
    partials = torch.empty(n_tiles, n_res, device=dev)
    kinds, pa, pb = index_tables(index)
    launch("jet_gated_bwd", ptrs(y), ptrs(u) if gated else None, ptrs(v) if gated else None, ptrs(g_out),
           ptrs(g_y), ptrs(g_u) if gated else None, ptrs(g_v) if gated else None, ptrs(weights),
           ptrs(biases), ptrs(_alpha_table(program, alphas)), ptrs(table), ptrs(gzs),
           partials.data_ptr() if n_res else None, ints(dims), ints(program), ints(kinds), ints(pa),
           ints(pb), S, L, N, kmax, int(jet_mlp.bwd_parks(S, dims)), act_id, act_w, stream_handle(dev))
    jet_gated_bwd.launches += 1
    ins = tuple(tuple(y) if l == 0 else tuple(t.unbind(0)) for l, t in enumerate(table))
    return g_y, g_u, g_v, gzs, ins, partials


_WRAPPERS = (jet_gated_fwd, jet_gated_bwd)
_PLAINS = (jet_gated_fwd_plain, jet_gated_bwd_plain)


def reset_counters() -> None:
    """Set this module's launch and plain-call counters to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0
    for fn in _PLAINS:
        fn.cuda_calls = 0


reset_counters()


# ------------------------------------------------------- autograd wrapper --


class _JetGatedSegment(torch.autograd.Function):
    """Forward through :func:`jet_gated_fwd`; backward through
    :func:`jet_gated_bwd` and ``jet_wgrad`` (dW, db and d alpha). In
    recompute mode (``save_bounds`` False) the backward first re-runs the
    forward kernel in save mode to get the stage boundaries. Inputs that
    need no gradient get None, and ``jet_wgrad`` is not launched where no
    weight, bias or alpha needs one. Once differentiable, like
    ``ops/jet_mlp.py::_JetMLPSegment``."""

    @staticmethod
    def forward(ctx, index, program, save_bounds, act, *tensors):
        S, L = len(index), len(program)
        n_uv = S if _has_gates(program) else 0
        cuts = [S, S + n_uv, S + 2 * n_uv, S + 2 * n_uv + L, S + 2 * n_uv + 2 * L]
        y, u, v, weights, biases, alphas = (tensors[a:b] for a, b in zip([0] + cuts, cuts + [len(tensors)]))
        n_stages = len(_stages(program))
        outs, bounds = jet_gated_fwd(y, u, v, weights, biases, alphas, program, index,
                                     save_bounds and n_stages > 1, act)
        ctx.index, ctx.program, ctx.act, ctx.cuts, ctx.n_in = index, program, act, cuts, len(tensors)
        ctx.save_for_backward(*tensors, *bounds)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *g_out):
        saved = ctx.saved_tensors
        cuts = ctx.cuts
        y, u, v, weights, biases, alphas = (saved[a:b] for a, b in zip([0] + cuts, cuts + [ctx.n_in]))
        bounds = saved[ctx.n_in :]
        if len(_stages(ctx.program)) > 1 and not bounds:
            _, bounds = jet_gated_fwd(y, u, v, weights, biases, alphas, ctx.program, ctx.index, save_bounds=True,
                                      act=ctx.act)
        g_y, g_u, g_v, gzs, ins, partials = jet_gated_bwd(y, u, v, bounds, weights, biases, alphas, g_out,
                                                          ctx.program, ctx.index, ctx.act)
        need = ctx.needs_input_grad[4:]
        n_streams = cuts[2]
        g_streams = tuple(g if n else None for g, n in zip((*g_y, *g_u, *g_v), need[:n_streams]))
        if not any(need[n_streams:]):  # frozen weights, biases and alphas: no jet_wgrad
            return (None, None, None, None, *g_streams, *(None,) * (ctx.n_in - n_streams))
        dws, dbs, d_alpha = jet_mlp.jet_wgrad(ins, gzs, alpha_partials=partials)
        grads = (*dws, *dbs, *d_alpha.reshape(-1, 1).unbind(0))
        return (None, None, None, None, *g_streams, *(g if n else None for g, n in zip(grads, need[n_streams:])))


def jet_gated_segment(jy: jetmod.Jet, ju: Optional[jetmod.Jet], jv: Optional[jetmod.Jet],
                      weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                      alphas: Sequence[torch.Tensor], program: Program,
                      save_bounds: bool = False, act: jetmod.Act = TANH) -> jetmod.Jet:
    """Run a layer program on every stream of ``jy`` as one fused segment
    (kernels on CUDA, plain versions on the CPU), differentiable with
    respect to the ``y``, ``u``, ``v`` streams, weights, biases and alphas.
    ``ju``/``jv`` may be None for a program without gates. Widths that are
    no multiple of 4 run zero-padded (``ops/jet_mlp.py::pad_widths``; a
    program with residuals, one width throughout, pads ``y`` too): the
    padded columns of ``u`` and ``v`` are 0, so the gate keeps them 0."""
    program = tuple(int(op) for op in program)
    d_out = int(weights[-1].shape[1])
    pad_in = _n_residuals(program) > 0
    weights, biases = jet_mlp.pad_widths(weights, biases, pad_input=pad_in)
    ys = tuple(jet_mlp.pad_cols(s, int(weights[0].shape[0])) for s in jy.streams)
    uv = ()
    if _has_gates(program):
        wuv = jet_mlp._round4(int(ju.streams[0].shape[1]))
        uv = tuple(jet_mlp.pad_cols(s, wuv) for s in (*ju.streams, *jv.streams))
    outs = _JetGatedSegment.apply(jy.index, program, save_bounds, act, *ys, *uv, *weights, *biases, *alphas)
    return jetmod.Jet(tuple(o[:, :d_out] for o in outs) if d_out % 4 else outs, jy.index)
