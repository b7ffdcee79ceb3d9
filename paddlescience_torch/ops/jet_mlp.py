"""Fused Taylor-jet segments of an ungated MLP: three hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of ``paddlescience_tpu/ops/jet_pallas.py`` for the MLP body
(``arch/mlp.py::_mlp_segment_fn``, no gate). A segment is L consecutive
``linear + activation`` layers applied to all S streams of a jet. The
activation is any rule of ``autodiff/jet.py::ACT_RULES``, passed to every
wrapper and plain version as ``act = (id, parameter)`` (default tanh):

* :func:`jet_mlp_fwd` (``csrc/jet_mlp_fwd.cu``) replaces ``_forward``
  (``jet_pallas.py:361``): the segment forward, optionally saving the stage
  boundaries;
* :func:`jet_mlp_bwd` (``csrc/jet_mlp_bwd.cu``) replaces the per-tile part
  of ``_bwd`` (``jet_pallas.py:557``): the staged, rematerializing backward
  that yields the input-stream cotangents and every layer's pre-activation
  cotangents ``gz``;
* :func:`jet_wgrad` (``csrc/jet_wgrad.cu``) replaces ``_bwd``'s cross-grid
  weight-gradient sum (``jet_pallas.py:526-537``) with a deterministic
  split-K reduction.

:class:`_JetMLPSegment` wraps the three in one ``torch.autograd.Function``.
It receives the *effective* weights (RWF ``g * v`` or weight norm
``g v / |v|`` is formed outside in plain torch), so autograd carries their
gradient on to the parameters.

Every wrapper takes its plain version for tensors on the CPU, and only
there; for a CUDA tensor it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches; ``<plain>.cuda_calls`` counts calls of a plain
version on CUDA tensors (which only a comparison run makes).

Precision: the kernels compute in true float32 (FFMA, no TF32), which is
what the JAX package calls "highest".

Stream layout: a stream is an (N, W) float32 tensor; weights are (K, D)
and used as ``x @ W``; stage boundaries and ``gz`` are (S, N, D) per layer.

Limits: S <= 8 streams, widths <= 512. A CTA's row tile is 16 rows up to
width 256 and 8 rows above (:func:`tile_rows`); the backward keeps the
layer input and the running cotangent in shared memory where both fit and
otherwise parks the cotangent in the ``gz`` buffers (:func:`bwd_parks`).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from paddlescience_torch.autodiff import jet as jetmod
from paddlescience_torch.ops import cuda_build
from paddlescience_torch.ops.cuda_build import F, I, P, ints, is_cpu, launch, on_device, ptrs, stream_handle

__all__ = [
    "TANH",
    "index_tables",
    "tile_rows",
    "bwd_parks",
    "act_jet",
    "act_jet_vjp",
    "jet_mlp_fwd",
    "jet_mlp_bwd",
    "jet_wgrad",
    "jet_mlp_fwd_plain",
    "jet_mlp_bwd_plain",
    "jet_wgrad_plain",
    "jet_mlp_segment",
    "reset_counters",
]

BM = 16  # rows per CTA tile up to NARROW_WIDTH (and always in the gated kernels)
BM_WIDE = 8  # rows per CTA tile above NARROW_WIDTH
NARROW_WIDTH = 256
MAX_STREAMS = 8
MAX_LAYERS = 32
MAX_WIDTH = 512
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on Hopper
KC = 16  # weight rows (or columns) staged per chunk
WG_TILE, WG_RC = 64, 32  # jet_wgrad output tile edge and staged batch rows
TANH: jetmod.Act = (jetmod.TANH, 0.0)

Tensors = Tuple[torch.Tensor, ...]


def index_tables(index: jetmod.JetIndex) -> Tuple[List[int], List[int], List[int]]:
    """Per stream: kind (0 primal, 1 single, 2 pair) and, for pairs, the
    stream positions of its two singles."""
    kinds, pa, pb = [], [], []
    for m in index.multis:
        kinds.append(len(m))
        if len(m) == 2:
            pa.append(index.pos[(m[0],)])
            pb.append(index.pos[(m[1],)])
        else:
            pa.append(0)
            pb.append(0)
    return kinds, pa, pb


# ----------------------------------------------------------- plain versions --


def _note_plain_call(fn, t: torch.Tensor) -> None:
    if t.is_cuda:
        fn.cuda_calls += 1


def act_jet(z, tables, act: jetmod.Act = TANH):
    """The jet rule of ``act`` on pre-activation streams z:
    y_0 = f(z_0), y_k = f' z_k, y_ij = f'' z_i z_j + f' z_ij."""
    kinds, pa, pb = tables
    f, f1, f2, _ = jetmod.act_derivs(act, z[0])
    return [f] + [f1 * z[s] if kinds[s] == 1 else f2 * z[pa[s]] * z[pb[s]] + f1 * z[s] for s in range(1, len(z))]


def jet_mlp_fwd_plain(streams: Sequence[torch.Tensor], weights, biases,
                      index: jetmod.JetIndex, save_bounds: bool = False,
                      act: jetmod.Act = TANH) -> Tuple[Tensors, Tensors]:
    """Per-stream ``@`` products and the jet rule of ``act``. Returns the
    output streams and, with ``save_bounds``, the L-1 stage boundaries as
    (S, N, D) tensors (the jets entering layers 1..L-1)."""
    _note_plain_call(jet_mlp_fwd_plain, streams[0])
    tables = index_tables(index)
    y = list(streams)
    bounds = []
    for l, (w, b) in enumerate(zip(weights, biases)):
        if save_bounds and l > 0:
            bounds.append(torch.stack(y))
        z = jetmod.linear(jetmod.Jet(y, index), w, b).streams
        y = act_jet(z, tables, act)
    return tuple(y), tuple(bounds)


def act_jet_vjp(z, g, tables, act: jetmod.Act = TANH):
    """VJP of the jet rule of ``act`` at pre-activations ``z`` (S streams)
    for output cotangents ``g``: the pre-activation cotangents

        gz_0  = f' g_0 + f'' sum_k g_k z_k + sum_ij (f3 z_i z_j + f'' z_ij) g_ij
        gz_k  = f' g_k + sum over pairs ij containing k of f'' g_ij z_other
                (the pair (k, k) contributes 2 f'' g_kk z_k)
        gz_ij = f' g_ij

    with f3 the third derivative of the activation at z_0."""
    kinds, pa, pb = tables
    _, sp, spp, sppp = jetmod.act_derivs(act, z[0])
    gz = [sp * gs for gs in g]
    for s in range(1, len(g)):
        if kinds[s] == 1:
            gz[0] = gz[0] + spp * g[s] * z[s]
        else:
            za, zb = z[pa[s]], z[pb[s]]
            gz[0] = gz[0] + (sppp * za * zb + spp * z[s]) * g[s]
            gz[pa[s]] = gz[pa[s]] + spp * g[s] * zb
            gz[pb[s]] = gz[pb[s]] + spp * g[s] * za
    return gz


def jet_mlp_bwd_plain(streams, bounds, weights, biases, g_out,
                      index: jetmod.JetIndex, act: jetmod.Act = TANH) -> Tuple[Tensors, Tensors]:
    """Hand-derived VJP of the segment. Returns the cotangents of the input
    streams and, per layer, the pre-activation cotangents gz as (S, N, D)."""
    _note_plain_call(jet_mlp_bwd_plain, streams[0])
    tables = index_tables(index)
    ins = [tuple(streams)] + [tuple(bd.unbind(0)) for bd in bounds]
    g = list(g_out)
    gzs = [None] * len(weights)
    for l in reversed(range(len(weights))):
        w = weights[l]
        z = [s @ w for s in ins[l]]
        z[0] = z[0] + biases[l]
        gz = act_jet_vjp(z, g, tables, act)
        gzs[l] = torch.stack(gz)
        g = [x @ w.t() for x in gz]
    return tuple(g), tuple(gzs)


def jet_wgrad_plain(ys: Sequence[Sequence[torch.Tensor]], gzs: Sequence[torch.Tensor]):
    """dW_l = sum_s y_in_s^T @ gz_s and db_l = sum over rows of gz_0, for
    each layer l; ``ys[l]`` is the S input streams of layer l."""
    _note_plain_call(jet_wgrad_plain, gzs[0])
    dws, dbs = [], []
    for y, gz in zip(ys, gzs):
        dw = y[0].t() @ gz[0]
        for s in range(1, len(y)):
            dw = dw + y[s].t() @ gz[s]
        dws.append(dw)
        dbs.append(gz[0].sum(0))
    return tuple(dws), tuple(dbs)


for _fn in (jet_mlp_fwd_plain, jet_mlp_bwd_plain, jet_wgrad_plain):
    _fn.cuda_calls = 0


# ----------------------------------------------------------- CUDA wrappers --

cuda_build.declare("jet_mlp_fwd", [P] * 9 + [I] * 6 + [F, P])
cuda_build.declare("jet_mlp_bwd", [P] * 11 + [I] * 7 + [F, P])
cuda_build.declare("jet_wgrad", [P] * 6 + [I] * 7 + [P])


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _segment_dims(streams, weights, biases, index, max_width: int = MAX_WIDTH) -> List[int]:
    S, L = len(streams), len(weights)
    if S != len(index) or not 1 <= S <= MAX_STREAMS:
        raise ValueError(f"need 1..{MAX_STREAMS} streams matching the index, got {S}")
    if not 1 <= L <= MAX_LAYERS or len(biases) != L:
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one bias each, got {L}")
    dims = [int(streams[0].shape[1])]
    for w, b in zip(weights, biases):
        if w.dim() != 2 or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer shapes do not chain: W {tuple(w.shape)}, b {tuple(b.shape)} "
                             f"after width {dims[-1]}")
        dims.append(int(w.shape[1]))
    if max(dims) > max_width or any(d % 4 for d in dims[1:]):
        raise ValueError(f"the kernels take widths <= {max_width}, layer outputs a multiple "
                         f"of 4; got {dims}")
    for s in streams:
        if tuple(s.shape) != tuple(streams[0].shape):
            raise ValueError("all streams of a jet share one shape")
    return dims


def act_args(act: jetmod.Act) -> Tuple[int, float]:
    """(id, parameter) as the kernels take them; refuses an unknown id."""
    if act[0] not in jetmod.ACT_RULES:
        raise ValueError(f"unknown activation id {act[0]}")
    return int(act[0]), float(act[1])


def tile_rows(dims: Sequence[int]) -> int:
    """Rows of a CTA's tile: 16 up to NARROW_WIDTH (64 threads across the
    columns, 4 down the rows), 8 above (128 across, 2 down), so a thread
    always owns a 4x4 micro-tile of every stream."""
    return BM if max(dims) <= NARROW_WIDTH else BM_WIDE


def fwd_smem(S: int, dims: Sequence[int]) -> int:
    """Shared-memory bytes of the forward kernels: the S-stream row tile
    at the widest layer and one weight chunk."""
    return (S * _round4(max(dims)) * tile_rows(dims) + KC * max(dims[1:])) * 4


def bwd_parks(S: int, dims: Sequence[int]) -> bool:
    """Whether jet_mlp_bwd parks the running cotangent in device memory
    (in the gz buffers) instead of a second shared-memory tile: where the
    layer-input tile, the cotangent tile and a weight chunk do not fit."""
    kmax = _round4(max(dims))
    return (2 * S * kmax * tile_rows(dims) + KC * (kmax + 4)) * 4 > SMEM_LIMIT


def bwd_smem(S: int, dims: Sequence[int]) -> int:
    kmax = _round4(max(dims))
    tiles = 1 if bwd_parks(S, dims) else 2
    return (tiles * S * kmax * tile_rows(dims) + KC * (kmax + 4)) * 4


def jet_mlp_fwd(streams: Sequence[torch.Tensor], weights, biases, index: jetmod.JetIndex,
                save_bounds: bool = False, act: jetmod.Act = TANH) -> Tuple[Tensors, Tensors]:
    """Segment forward; returns (output streams, stage boundaries)."""
    if is_cpu(streams[0]):
        return jet_mlp_fwd_plain(streams, weights, biases, index, save_bounds, act)
    dev = streams[0].device
    dims = _segment_dims(streams, weights, biases, index)
    S, L, N = len(streams), len(weights), int(streams[0].shape[0])
    kmax = _round4(max(dims))
    act_id, act_w = act_args(act)
    if fwd_smem(S, dims) > SMEM_LIMIT:
        raise ValueError(f"jet_mlp_fwd: {S} streams of width {kmax} exceed shared memory")
    streams = [on_device(s, dev) for s in streams]
    weights = [on_device(w, dev) for w in weights]
    biases = [on_device(b, dev) for b in biases]
    outs = tuple(torch.empty(N, dims[-1], device=dev) for _ in range(S))
    bounds = tuple(torch.empty(S, N, dims[l + 1], device=dev) for l in range(L - 1)) if save_bounds else ()
    kinds, pa, pb = index_tables(index)
    launch("jet_mlp_fwd", ptrs(streams), ptrs(weights), ptrs(biases), ptrs(outs),
           ptrs(bounds) if bounds else None, ints(dims), ints(kinds), ints(pa), ints(pb),
           S, L, N, kmax, tile_rows(dims), act_id, act_w, stream_handle(dev))
    jet_mlp_fwd.launches += 1
    return outs, bounds


def jet_mlp_bwd(streams, bounds, weights, biases, g_out,
                index: jetmod.JetIndex, act: jetmod.Act = TANH) -> Tuple[Tensors, Tensors]:
    """Segment backward from the stage boundaries; returns (input-stream
    cotangents, per-layer gz)."""
    if is_cpu(streams[0]):
        return jet_mlp_bwd_plain(streams, bounds, weights, biases, g_out, index, act)
    dev = streams[0].device
    dims = _segment_dims(streams, weights, biases, index)
    S, L, N = len(streams), len(weights), int(streams[0].shape[0])
    if len(bounds) != L - 1 or len(g_out) != S:
        raise ValueError(f"jet_mlp_bwd: need {L - 1} boundaries and {S} cotangents")
    kmax = _round4(max(dims))
    act_id, act_w = act_args(act)
    if bwd_smem(S, dims) > SMEM_LIMIT:
        raise ValueError(f"jet_mlp_bwd: {S} streams of width {kmax} exceed shared memory")
    streams = [on_device(s, dev) for s in streams]
    bounds = [on_device(b, dev) for b in bounds]
    weights = [on_device(w, dev) for w in weights]
    biases = [on_device(b, dev) for b in biases]
    g_out = [on_device(g, dev) for g in g_out]
    g_in = tuple(torch.empty(N, dims[0], device=dev) for _ in range(S))
    gzs = tuple(torch.empty(S, N, dims[l + 1], device=dev) for l in range(L))
    kinds, pa, pb = index_tables(index)
    launch("jet_mlp_bwd", ptrs(streams), ptrs(bounds) if bounds else None, ptrs(weights),
           ptrs(biases), ptrs(g_out), ptrs(g_in), ptrs(gzs), ints(dims), ints(kinds),
           ints(pa), ints(pb), S, L, N, kmax, tile_rows(dims), int(bwd_parks(S, dims)), act_id, act_w,
           stream_handle(dev))
    jet_mlp_bwd.launches += 1
    return g_in, gzs


def _wgrad_splits(dev: torch.device, tiles: int, n: int) -> Tuple[int, int]:
    """Row splits P and rows per split: about four CTAs per SM in all."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = max(1, min(math.ceil(n / WG_RC), math.ceil(4 * sms / tiles)))
    rows_per = math.ceil(math.ceil(n / p) / WG_RC) * WG_RC
    return math.ceil(n / rows_per), rows_per


def jet_wgrad(ys: Sequence[Sequence[torch.Tensor]], gzs: Sequence[torch.Tensor]):
    """Per-layer weight and bias gradients summed over the batch; ``ys[l]``
    is the S input streams of layer l, ``gzs[l]`` its (S, N, D) gz."""
    if is_cpu(gzs[0]):
        return jet_wgrad_plain(ys, gzs)
    dev = gzs[0].device
    L, S, N = len(gzs), int(gzs[0].shape[0]), int(gzs[0].shape[1])
    if len(ys) != L or any(len(y) != S for y in ys) or not (1 <= S <= MAX_STREAMS and 1 <= L <= MAX_LAYERS):
        raise ValueError("jet_wgrad: need S input streams for each of the L layers")
    dims = [int(ys[0][0].shape[1])] + [int(g.shape[2]) for g in gzs]
    for l in range(L):
        if any(tuple(t.shape) != (N, dims[l]) for t in ys[l]) or tuple(gzs[l].shape) != (S, N, dims[l + 1]):
            raise ValueError(f"jet_wgrad: layer {l} shapes do not match")
    ys = [[on_device(t, dev) for t in y] for y in ys]
    gzs = [on_device(g, dev) for g in gzs]
    kmax, dmax = max(dims[:-1]), max(dims[1:])
    tiles = L * math.ceil(kmax / WG_TILE) * math.ceil(dmax / WG_TILE)
    splits, rows_per = _wgrad_splits(dev, tiles, N)
    part = torch.empty(L * splits * (kmax * dmax + dmax), device=dev)
    dws = tuple(torch.empty(dims[l], dims[l + 1], device=dev) for l in range(L))
    dbs = tuple(torch.empty(dims[l + 1], device=dev) for l in range(L))
    launch("jet_wgrad", ptrs([t for y in ys for t in y]), ptrs(gzs), ptrs(dws), ptrs(dbs),
           part.data_ptr(), ints(dims), S, L, N, splits, rows_per, kmax, dmax, stream_handle(dev))
    jet_wgrad.launches += 1
    return dws, dbs


def reset_counters() -> None:
    """Set every launch and plain-call counter to 0."""
    for fn in (jet_mlp_fwd, jet_mlp_bwd, jet_wgrad):
        fn.launches = 0
    for fn in (jet_mlp_fwd_plain, jet_mlp_bwd_plain, jet_wgrad_plain):
        fn.cuda_calls = 0


reset_counters()


# ------------------------------------------------------- autograd wrapper --


class _JetMLPSegment(torch.autograd.Function):
    """Forward through :func:`jet_mlp_fwd`; backward through
    :func:`jet_mlp_bwd` and :func:`jet_wgrad`. In recompute mode
    (``save_bounds`` False) the backward first re-runs the forward kernel
    in save mode to get the stage boundaries. The backward kernels are not
    differentiable themselves: a second derivative through the segment
    raises."""

    @staticmethod
    def forward(ctx, index, save_bounds, n_layers, act, *tensors):
        S = len(index)
        streams = tensors[:S]
        weights = tensors[S : S + n_layers]
        biases = tensors[S + n_layers :]
        outs, bounds = jet_mlp_fwd(streams, weights, biases, index, save_bounds and n_layers > 1, act)
        ctx.index, ctx.n_layers, ctx.act = index, n_layers, act
        ctx.save_for_backward(*streams, *weights, *biases, *bounds)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *g_out):
        S, L = len(ctx.index), ctx.n_layers
        saved = ctx.saved_tensors
        streams = saved[:S]
        weights = saved[S : S + L]
        biases = saved[S + L : S + 2 * L]
        bounds = saved[S + 2 * L :]
        if L > 1 and not bounds:
            _, bounds = jet_mlp_fwd(streams, weights, biases, ctx.index, save_bounds=True, act=ctx.act)
        g_in, gzs = jet_mlp_bwd(streams, bounds, weights, biases, g_out, ctx.index, ctx.act)
        ys = [streams] + [b.unbind(0) for b in bounds]
        dws, dbs = jet_wgrad(ys, gzs)
        return (None, None, None, None, *g_in, *dws, *dbs)


def jet_mlp_segment(jx: jetmod.Jet, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                    save_bounds: bool = False, act: jetmod.Act = TANH) -> jetmod.Jet:
    """Run L ``linear + act`` layers on every stream of ``jx`` as one fused
    segment (kernels on CUDA, plain versions on the CPU), differentiable
    with respect to the input streams, weights and biases."""
    outs = _JetMLPSegment.apply(jx.index, save_bounds, len(weights), act, *jx.streams, *weights, *biases)
    return jetmod.Jet(outs, jx.index)
