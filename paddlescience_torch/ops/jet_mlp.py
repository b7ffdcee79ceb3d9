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
  split-K reduction over work units that :func:`wgrad_plan` sizes to whole
  waves of the card; given the gated backward's d alpha partials it sums
  them in the same launch.

:class:`_JetMLPSegment` wraps the three in one ``torch.autograd.Function``.
It receives the *effective* weights (RWF ``g * v`` or weight norm
``g v / |v|`` is formed outside in plain torch), so autograd carries their
gradient on to the parameters.

Every wrapper takes its plain version for tensors on the CPU, and only
there; for a CUDA tensor it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches; ``<plain>.cuda_calls`` counts calls of a plain
version on CUDA tensors (which only a comparison run makes).

Precision: float32, what the JAX package calls "highest". The backward
kernels and ``jet_wgrad`` compute in FFMA; the forward kernels' products
run on the tensor cores in 3xTF32 (each float32 operand split into two
TF32 parts, three TF32 products; ``csrc/jet_common.cuh::fwd_matmul``),
which keeps float32 accuracy.

Stream layout: a stream is an (N, W) float32 tensor; weights are (K, D)
and used as ``x @ W``; stage boundaries and ``gz`` are (S, N, D) per layer.

Limits: :func:`kernels_take` is the one statement of what the jet kernels
(these and ``ops/jet_gated.py``'s) take: 1..16 streams (1..8 gated),
1..32 layers, widths <= 512 (<= 256 gated), layer outputs a multiple of
4, and the forward's and backward's shared memory within a CTA's; the
wrappers raise where it does not hold. :func:`jet_mlp_segment` (and
``ops/jet_gated.py::jet_gated_segment``) zero-pad widths that are no
multiple of 4 (:func:`pad_widths`). A CTA's row tile is 16 rows up to width
256 where the S-stream tiles fit shared memory, else 8 rows
(:func:`tile_rows`); both backward kernels keep the layer input and the
running cotangent in shared memory where both fit beside their weight ring
and otherwise park the cotangent in the ``gz`` buffers (:func:`bwd_parks`;
the gated backward's widths stop at 256, so its tiles are always 16 rows).
Above GROUP_STREAMS streams the ungated kernels run each product over two
halves of the streams in turn (``csrc/jet_mlp_fwd.cu``,
``jet_mlp_bwd.cu``) and the backward always parks: at width 256 that is
16-row tiles up to 11 streams, 8-row tiles for 12-16; at width 512 the
forward's 8-row tile holds 8 streams, so 9 are refused there.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    "fwd_kst",
    "fwd_smem",
    "bwd_smem",
    "kernels_take",
    "kernel_refusal",
    "KernelRefusal",
    "act_jet",
    "act_jet_vjp",
    "jet_mlp_fwd",
    "jet_mlp_bwd",
    "jet_wgrad",
    "jet_mlp_fwd_plain",
    "jet_mlp_bwd_plain",
    "jet_wgrad_plain",
    "jet_alpha_reduce_plain",
    "wgrad_plan",
    "jet_mlp_segment",
    "pad_widths",
    "reset_counters",
]

BM = 16  # rows per CTA tile up to NARROW_WIDTH (and always in the gated kernels)
BM_WIDE = 8  # rows per CTA tile above NARROW_WIDTH
NARROW_WIDTH = 256
MAX_STREAMS = 16  # the ungated kernels
GATED_MAX_STREAMS = 8  # the gated kernels
GROUP_STREAMS = 8  # streams whose accumulators one product of the ungated kernels holds in registers
MAX_LAYERS = 32
MAX_WIDTH = 512
GATED_MAX_WIDTH = 256  # the gated kernels keep the 16-row tile of the narrow case
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on Hopper
KC = 16  # weight rows (or columns) staged per chunk
FW_STAGES = 3  # the forward kernels: weight chunks in their cp.async ring
GB_STAGES = 2  # the backward kernels: weight chunks in their cp.async ring
WG_T, WG_RC, WG_NARROW = 128, 32, 8  # jet_wgrad: tile edge, rows per stage, widest layer of narrow units
WG_PART = WG_T * WG_T + WG_T  # floats of one jet_wgrad unit's partial (its dW tile, then db)
WG_NARROW_COST = 0.25  # time per row of a narrow unit, in rows of a 128 x 128 unit
WG_UNIT_COST = 3 * WG_RC  # a unit's time outside its row loop (ring fill, writing its partial), in rows
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


def jet_alpha_reduce_plain(partials: torch.Tensor) -> torch.Tensor:
    """(n_tiles, n_residuals) partial sums of d alpha -> (n_residuals,)."""
    _note_plain_call(jet_alpha_reduce_plain, partials)
    return partials.sum(0)


_PLAINS = (jet_mlp_fwd_plain, jet_mlp_bwd_plain, jet_wgrad_plain, jet_alpha_reduce_plain)


# ----------------------------------------------------------- CUDA wrappers --

cuda_build.declare("jet_mlp_fwd", [P] * 9 + [I] * 6 + [F, P])
cuda_build.declare("jet_mlp_bwd", [P] * 11 + [I] * 7 + [F, P])
cuda_build.declare("jet_wgrad", [P] * 10 + [I] * 5 + [P])
cuda_build.declare("jet_wgrad_slots", [P], library="jet_wgrad")


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class KernelRefusal(ValueError):
    """The jet kernels refuse a segment's shape (:func:`kernel_refusal`),
    decided before any launch. The autotuner drops a candidate for this
    error alone."""


def _segment_dims(streams, weights, biases, index, gated: bool = False) -> List[int]:
    """The segment's widths dims[0] -> ... -> dims[L]; raises ValueError
    where the shapes do not chain, :class:`KernelRefusal` where the kernels
    refuse them."""
    S, L = len(streams), len(weights)
    if S != len(index):
        raise ValueError(f"need one stream per entry of the jet index ({len(index)}), got {S}")
    if len(biases) != L:
        raise ValueError(f"need one bias per layer, got {len(biases)} for {L} layers")
    dims = [int(streams[0].shape[1])]
    for w, b in zip(weights, biases):
        if w.dim() != 2 or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer shapes do not chain: W {tuple(w.shape)}, b {tuple(b.shape)} "
                             f"after width {dims[-1]}")
        dims.append(int(w.shape[1]))
    for s in streams:
        if tuple(s.shape) != tuple(streams[0].shape):
            raise ValueError("all streams of a jet share one shape")
    reason = kernel_refusal(S, dims, gated)
    if reason:
        raise KernelRefusal(reason)
    return dims


def act_args(act: jetmod.Act) -> Tuple[int, float]:
    """(id, parameter) as the kernels take them; refuses an unknown id."""
    if act[0] not in jetmod.ACT_RULES:
        raise ValueError(f"unknown activation id {act[0]}")
    return int(act[0]), float(act[1])


def fwd_kst(dims: Sequence[int]) -> int:
    """Row stride (floats) of the forward kernels' shared tile: the widest
    layer rounded up to 32, the span of its column swizzle
    (``csrc/jet_common.cuh::fwd_at``)."""
    return _round_up(max(dims), 32)


def _fwd_bytes(S: int, dims: Sequence[int], rows: int) -> int:
    return (S * rows * fwd_kst(dims) + FW_STAGES * KC * (_round_up(max(dims[1:], default=dims[0]), 16) + 4)) * 4


def _bwd_parks_at(S: int, dims: Sequence[int], rows: int) -> bool:
    kmax = _round4(max(dims))
    return S > GROUP_STREAMS or (2 * S * kmax * rows + GB_STAGES * KC * kmax) * 4 > SMEM_LIMIT


def _bwd_bytes(S: int, dims: Sequence[int], rows: int) -> int:
    kmax = _round4(max(dims))
    tiles = 1 if _bwd_parks_at(S, dims, rows) else 2
    return (tiles * S * kmax * rows + GB_STAGES * KC * kmax) * 4


def tile_rows(S: int, dims: Sequence[int]) -> int:
    """Rows of a CTA's tile: 16 up to NARROW_WIDTH where both kernels'
    S-stream tiles fit shared memory at 16 rows, else 8. In the forward
    kernels a warp owns two 16-column m-tiles of every stream and row: 8
    warps at 16 rows (256 columns), 16 warps at 8 rows (512); in the
    backward kernels (512 threads) a thread owns a 4x2 micro-tile: 128
    threads across the columns by 4 down the rows, or 256 by 2. Up to 8
    streams every width <= 256 takes 16 rows; at width 256 streams 12-16
    take 8."""
    if max(dims) > NARROW_WIDTH:
        return BM_WIDE
    return BM if max(_fwd_bytes(S, dims, BM), _bwd_bytes(S, dims, BM)) <= SMEM_LIMIT else BM_WIDE


def fwd_smem(S: int, dims: Sequence[int]) -> int:
    """Shared-memory bytes of the forward kernels (``csrc/jet_common.cuh::
    fwd_smem``): the S-stream row tile of :func:`tile_rows` rows at row
    stride :func:`fwd_kst` and a ring of FW_STAGES weight chunks of KC rows
    at the widest output rounded up to 16, plus 4 (``fwd_ring_stride``,
    which keeps the fragment loads free of bank conflicts). At S = 4,
    width 256 that is 115,456 bytes, so two CTAs share an SM."""
    return _fwd_bytes(S, dims, tile_rows(S, dims))


def bwd_parks(S: int, dims: Sequence[int]) -> bool:
    """Whether a backward kernel keeps one tile for the layer input and the
    running cotangent, parking the cotangent in device memory (in the gz
    buffers): above GROUP_STREAMS streams always (``jet_mlp_bwd.cu``'s
    halves kernel), else where two tiles of :func:`tile_rows` rows and the
    ring of GB_STAGES weight chunks of KC x kmax do not fit. At width 256
    that is S >= 7, at width 512 S >= 6."""
    return _bwd_parks_at(S, dims, tile_rows(S, dims))


def bwd_smem(S: int, dims: Sequence[int]) -> int:
    """Shared-memory bytes of a backward kernel (``csrc/jet_common.cuh::
    bwd_smem``): its tiles and its ring."""
    return _bwd_bytes(S, dims, tile_rows(S, dims))


def kernel_refusal(S: int, dims: Sequence[int], gated: bool = False) -> Optional[str]:
    """Why the jet kernels refuse a segment of S streams through layers
    dims[0] -> ... -> dims[L] (the ungated kernels ``jet_mlp_{fwd,bwd}``
    and ``jet_wgrad``, or with ``gated`` the pair of ``ops/jet_gated.py``),
    or None where they take it. The one statement of the kernels' limits,
    on which the wrappers raise: 1..16 streams ungated, 1..8 gated; 1..32
    layers; widths <= 512 (<= 256 gated), layer outputs a multiple of 4;
    both kernels' shared memory at :func:`tile_rows` within a CTA's. Every
    S <= 16 at widths <= 256 fits; at widths 257-512 the forward's 8-row
    tile bounds S (8 at width 512)."""
    L = len(dims) - 1
    max_width, max_streams = (GATED_MAX_WIDTH, GATED_MAX_STREAMS) if gated else (MAX_WIDTH, MAX_STREAMS)
    if not 1 <= S <= max_streams:
        kind = "the gated kernels" if gated else "the kernels"
        return f"{kind} take 1..{max_streams} streams, got {S}"
    if not 1 <= L <= MAX_LAYERS:
        return f"the kernels take 1..{MAX_LAYERS} layers, got {L}"
    if max(dims) > max_width or any(d % 4 for d in dims[1:]):
        return f"the kernels take widths <= {max_width}, layer outputs a multiple of 4; got {list(dims)}"
    smem = max(fwd_smem(S, dims), bwd_smem(S, dims))
    if smem > SMEM_LIMIT:
        return (f"{S} streams of width {_round4(max(dims))} need {smem} bytes of shared memory, "
                f"more than a CTA's {SMEM_LIMIT}")
    return None


def kernels_take(S: int, dims: Sequence[int], gated: bool = False) -> bool:
    """Whether the jet kernels run a segment of S streams through layers
    dims[0] -> ... -> dims[L] (see :func:`kernel_refusal`)."""
    return kernel_refusal(S, dims, gated) is None


def jet_mlp_fwd(streams: Sequence[torch.Tensor], weights, biases, index: jetmod.JetIndex,
                save_bounds: bool = False, act: jetmod.Act = TANH) -> Tuple[Tensors, Tensors]:
    """Segment forward; returns (output streams, stage boundaries)."""
    if is_cpu(streams[0]):
        return jet_mlp_fwd_plain(streams, weights, biases, index, save_bounds, act)
    dev = streams[0].device
    dims = _segment_dims(streams, weights, biases, index)
    S, L, N = len(streams), len(weights), int(streams[0].shape[0])
    act_id, act_w = act_args(act)
    streams = [on_device(s, dev) for s in streams]
    weights = [on_device(w, dev) for w in weights]
    biases = [on_device(b, dev) for b in biases]
    outs = tuple(torch.empty(N, dims[-1], device=dev) for _ in range(S))
    bounds = tuple(torch.empty(S, N, dims[l + 1], device=dev) for l in range(L - 1)) if save_bounds else ()
    kinds, pa, pb = index_tables(index)
    launch("jet_mlp_fwd", ptrs(streams), ptrs(weights), ptrs(biases), ptrs(outs),
           ptrs(bounds) if bounds else None, ints(dims), ints(kinds), ints(pa), ints(pb),
           S, L, N, fwd_kst(dims), tile_rows(S, dims), act_id, act_w, stream_handle(dev))
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
           ints(pa), ints(pb), S, L, N, kmax, tile_rows(S, dims), int(bwd_parks(S, dims)), act_id, act_w,
           stream_handle(dev))
    jet_mlp_bwd.launches += 1
    return g_in, gzs


def wgrad_tiles(K: int, D: int) -> Tuple[int, int]:
    """(tile rows, tile columns) of a layer's dW in jet_wgrad: 128 x 128
    tiles, or one row of narrow 8 x 128 tiles where K <= WG_NARROW."""
    return (1 if K <= WG_NARROW else -(-K // WG_T)), -(-D // WG_T)


class WgradPlan(NamedTuple):
    """How jet_wgrad splits the S*N rows of each layer: ``splits[l]`` row
    ranges of ``rows[l]`` rows (the last may be shorter) per output tile;
    ``units`` CTAs in all, of which the card runs ``slots`` at once."""

    splits: Tuple[int, ...]
    rows: Tuple[int, ...]
    units: int
    slots: int

    @property
    def waves(self) -> int:
        return -(-self.units // self.slots)

    @property
    def tail(self) -> float:
        """Share of the launch's CTA slots that the last wave leaves empty."""
        return 1.0 - self.units / (self.waves * self.slots)


@functools.lru_cache(maxsize=256)
def wgrad_plan(dims: Tuple[int, ...], S: int, N: int, slots: int) -> WgradPlan:
    """The row split of every layer that minimises the launch's modelled
    time, waves x (the longest unit's rows + WG_UNIT_COST), for a card that
    runs ``slots`` units at once: units of one cost (a narrow unit takes
    1 / WG_NARROW_COST times the rows of a 128 x 128 one), so that they fill
    whole waves. Ties go to fewer units (less partial traffic)."""
    R, L = S * N, len(dims) - 1
    full = _round_up(R, WG_RC)
    tiles = [math.prod(wgrad_tiles(dims[l], dims[l + 1])) for l in range(L)]
    cost = [WG_NARROW_COST if dims[l] <= WG_NARROW else 1.0 for l in range(L)]
    best = None
    for target in range(WG_RC, full + 1, WG_RC):  # rows of a 128 x 128 unit
        splits, rows = [], []
        for c in cost:
            p = -(-R // min(full, _round_up(math.ceil(target / c), WG_RC)))
            splits.append(p)
            rows.append(_round_up(-(-R // p), WG_RC))
        units = sum(t * p for t, p in zip(tiles, splits))
        time = -(-units // slots) * (max(r * c for r, c in zip(rows, cost)) + WG_UNIT_COST)
        if best is None or (time, units) < best[0]:
            best = ((time, units), WgradPlan(tuple(splits), tuple(rows), units, slots))
    return best[1]


_SLOTS: Dict[int, int] = {}


def _wgrad_slots(dev: torch.device) -> int:
    """jet_wgrad units the card runs at once (SMs x resident CTAs), read
    from the built kernel once per device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SLOTS:
        out = ints([0])
        with torch.cuda.device(index):
            launch("jet_wgrad_slots", out)
        if out[0] < 1:
            raise RuntimeError("jet_wgrad: the kernel fits no SM")
        _SLOTS[index] = out[0]
    return _SLOTS[index]


@functools.lru_cache(maxsize=256)
def _wgrad_args(dims: Tuple[int, ...], S: int, N: int, slots: int):
    """(plan, C dims, C plan, sizes of each dW and db in one flat output,
    in order). Every size is a multiple of 4 floats where the widths are, so
    the kernel's float4 stores stay 16-byte aligned."""
    plan = wgrad_plan(dims, S, N, slots)
    sizes = [n for l in range(len(dims) - 1) for n in (dims[l] * dims[l + 1], dims[l + 1])]
    flat_plan = [v for pair in zip(plan.splits, plan.rows) for v in pair]
    return plan, ints(dims), ints(flat_plan), sizes


def _stream_block(streams: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """A layer's S input streams as one contiguous (S, N, K) block, as
    ``jet_wgrad`` takes every layer after the first: the tensor they are
    consecutive views of (a saved stage boundary, unbound), else a stacked
    copy. Returns a tensor whose data pointer is the block's base."""
    first = streams[0]
    step = first.numel() * first.element_size()
    views = all(t.device == dev and t.dtype == torch.float32 and t.is_contiguous() and t.shape == first.shape
                and t.data_ptr() == first.data_ptr() + s * step for s, t in enumerate(streams))
    if views and first.data_ptr() % 16 == 0:
        return first
    return torch.stack([on_device(t, dev) for t in streams])


def jet_wgrad(ys: Sequence[Sequence[torch.Tensor]], gzs: Sequence[torch.Tensor],
              alpha_partials: Optional[torch.Tensor] = None):
    """Per-layer weight and bias gradients summed over the batch; ``ys[l]``
    is the S input streams of layer l, ``gzs[l]`` its (S, N, D) gz. Returns
    ``(dws, dbs)``; with ``alpha_partials``, the (n_tiles, n_residuals) d
    alpha partial sums of ``ops/jet_gated.py::jet_gated_bwd``, also their
    sum over tiles from the same launch: ``(dws, dbs, d_alpha)``."""
    if is_cpu(gzs[0]):
        dws, dbs = jet_wgrad_plain(ys, gzs)
        return (dws, dbs) if alpha_partials is None else (dws, dbs, jet_alpha_reduce_plain(alpha_partials))
    dev = gzs[0].device
    L, S, N = len(gzs), int(gzs[0].shape[0]), int(gzs[0].shape[1])
    if len(ys) != L or any(len(y) != S for y in ys) or not (1 <= S <= MAX_STREAMS and 1 <= L <= MAX_LAYERS):
        raise ValueError("jet_wgrad: need S input streams for each of the L layers")
    dims = (int(ys[0][0].shape[1]),) + tuple(int(g.shape[2]) for g in gzs)
    for l in range(L):
        if any(tuple(t.shape) != (N, dims[l]) for t in ys[l]) or tuple(gzs[l].shape) != (S, N, dims[l + 1]):
            raise ValueError(f"jet_wgrad: layer {l} shapes do not match")
    if alpha_partials is not None and alpha_partials.dim() != 2:
        raise ValueError("jet_wgrad: alpha_partials is (n_tiles, n_residuals)")
    plan, c_dims, c_plan, sizes = _wgrad_args(dims, S, N, _wgrad_slots(dev))
    x = [on_device(t, dev) for t in ys[0]]
    blocks = [None] + [_stream_block(y, dev) for y in ys[1:]]
    gzs = [on_device(g, dev) for g in gzs]
    n_tiles, n_res = alpha_partials.shape if alpha_partials is not None else (0, 0)
    *parts, d_alpha = torch.empty(sum(sizes) + n_res, device=dev).split(sizes + [n_res])
    dws = tuple(p.view(dims[l], dims[l + 1]) for l, p in enumerate(parts[0::2]))
    dbs = tuple(parts[1::2])
    apart = on_device(alpha_partials, dev) if n_res else None
    part = torch.empty(plan.units * WG_PART, device=dev)
    launch("jet_wgrad", ptrs(x), ptrs(blocks), ptrs(gzs), ptrs(dws), ptrs(dbs), part.data_ptr(), c_dims, c_plan,
           apart.data_ptr() if n_res else None, d_alpha.data_ptr() if n_res else None, n_tiles, n_res,
           S, L, N, stream_handle(dev))
    jet_wgrad.launches += 1
    return (dws, dbs) if alpha_partials is None else (dws, dbs, d_alpha)


def reset_counters() -> None:
    """Set every launch and plain-call counter to 0."""
    for fn in (jet_mlp_fwd, jet_mlp_bwd, jet_wgrad):
        fn.launches = 0
    for fn in _PLAINS:
        fn.cuda_calls = 0


reset_counters()


# ------------------------------------------------------- autograd wrapper --


class _JetMLPSegment(torch.autograd.Function):
    """Forward through :func:`jet_mlp_fwd`; backward through
    :func:`jet_mlp_bwd` and :func:`jet_wgrad`. In recompute mode
    (``save_bounds`` False) the backward first re-runs the forward kernel
    in save mode to get the stage boundaries. The gradients of inputs that
    need none are None, and where no weight or bias needs one (a frozen
    network) ``jet_wgrad`` is not launched. The backward kernels are not
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
        need = ctx.needs_input_grad[4:]
        g_in = tuple(g if n else None for g, n in zip(g_in, need[:S]))
        if not any(need[S:]):  # frozen weights and biases: no jet_wgrad
            return (None, None, None, None, *g_in, *(None,) * (2 * L))
        ys = [streams] + [b.unbind(0) for b in bounds]
        dws, dbs = jet_wgrad(ys, gzs)
        grads = tuple(g if n else None for g, n in zip((*dws, *dbs), need[S:]))
        return (None, None, None, None, *g_in, *grads)


def pad_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to ``n`` (differentiable;
    ``t`` itself where it has that width)."""
    return t if t.shape[-1] == n else torch.nn.functional.pad(t, (0, n - t.shape[-1]))


def pad_widths(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
               pad_input: bool = False) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The layers with every output width zero-padded to a multiple of 4,
    the kernels' float4 rows (cylinder2d's width 50 runs at 52), and the next
    layer's input rows with it; with ``pad_input`` the first layer's input
    rows too. A padded column's pre-activations are 0 on every stream, and
    the zero weight rows below it add exact zeros to the real columns, so
    the real outputs and every gradient are those of the unpadded layers."""
    k_in = int(weights[0].shape[0])
    ins = [_round4(k_in) if pad_input else k_in] + [_round4(int(w.shape[1])) for w in weights[:-1]]
    ws = [w if tuple(w.shape) == (k, _round4(int(w.shape[1]))) else
          torch.nn.functional.pad(w, (0, _round4(int(w.shape[1])) - int(w.shape[1]), 0, k - int(w.shape[0])))
          for w, k in zip(weights, ins)]
    return ws, [pad_cols(b, _round4(int(b.shape[0]))) for b in biases]


def jet_mlp_segment(jx: jetmod.Jet, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                    save_bounds: bool = False, act: jetmod.Act = TANH) -> jetmod.Jet:
    """Run L ``linear + act`` layers on every stream of ``jx`` as one fused
    segment (kernels on CUDA, plain versions on the CPU), differentiable
    with respect to the input streams, weights and biases. Widths that are
    no multiple of 4 run zero-padded (:func:`pad_widths`)."""
    d_out = int(weights[-1].shape[1])
    weights, biases = pad_widths(weights, biases)
    outs = _JetMLPSegment.apply(jx.index, save_bounds, len(weights), act, *jx.streams, *weights, *biases)
    return jetmod.Jet(tuple(o[:, :d_out] for o in outs) if d_out % 4 else outs, jx.index)
