"""Segment sums and row gathers over static graphs, in a fixed order.

The JAX package sums messages with ``jax.ops.segment_sum(data, index,
num_segments)`` and gathers rows with ``x[index]``. In PyTorch the direct
counterparts (``index_add_``/``scatter_add_`` forwards, and the backward
of every gather) add with float atomics on CUDA, in an order that changes
from run to run. Every graph here is static and built on the host, so the
order is fixed once per graph instead:

* :class:`Segments` holds one index array (E,) into ``num_segments`` rows:
  the index itself (what a gather reads), the per-segment counts, the
  stable order that sorts the items by segment and each segment's first
  position in it. It is built in numpy on the host and copied to each
  device once (:meth:`Segments.on`).
* :func:`segment_sum` is ``F.embedding_bag(order, data, offsets,
  mode="sum")``: one bag a segment, whose kernel walks each bag's rows in
  order and writes its sum, without atomics, so a call repeats bitwise,
  reads nothing back to the host and can be captured in a CUDA graph. A
  segment with no items sums to 0, as ``jax.ops.segment_sum``. (On the
  H100 it took 0.0065 ms at a 4096-node kNN graph, hidden 64, against
  0.0092 for ``index_add_``, 0.0210 for ``torch.segment_reduce`` of the
  sorted rows and 0.0323 for a padded (segments, max degree) gather and
  sum: ``compare_segment_sum.py``, PERF.md §6.)
* :func:`gather` is ``x.index_select(0, index)``.
* Each is an ``autograd.Function`` whose backward is the other one on the
  same :class:`Segments`: a gather's backward is the segment sum of the
  cotangents, a segment sum's backward the gather of its cotangent. So
  forward and backward both repeat bitwise (``embedding_bag``'s own
  backward, which scatters with atomics, never runs).

:func:`gather_rows` reads rows at an index computed on the device (a
warp's sampling positions): its backward sums each row's cotangents in
the order of a stable sort of the index (``torch.sort``, then
``searchsorted`` for the row offsets and the same ``embedding_bag`` sum),
with no read back to the host, so it too repeats bitwise and runs inside
a CUDA graph.

:func:`segment_sum_plain` and :func:`gather_plain` are the direct
versions (``index_add_`` and advanced indexing), kept for the tests and
the card's timing, never on a model's path.

Indices are host arrays (numpy, or CPU tensors): an index that lives on
the card would have to be read back to build the table. :func:`segments`
keeps one :class:`Segments` per distinct (index, num_segments).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Segments", "segments", "segment_sum", "gather", "gather_rows", "segment_sum_plain", "gather_plain"]

IndexLike = Union[np.ndarray, torch.Tensor, "Segments"]


def _host_index(index) -> np.ndarray:
    if isinstance(index, torch.Tensor):
        if index.device.type != "cpu":
            raise ValueError("graph indices must be host arrays (numpy or CPU tensors): building the segment "
                             f"table from an index on {index.device} would read it back from the device")
        index = index.numpy()
    return np.ascontiguousarray(np.asarray(index).reshape(-1), dtype=np.int64)


class Segments:
    """One static index (E,) into ``num_segments`` rows, with its stable
    sorting order and segment offsets (module docstring)."""

    def __init__(self, index, num_segments: int):
        index = _host_index(index)
        num_segments = int(num_segments)
        if index.size and (index.min() < 0 or index.max() >= num_segments):
            raise ValueError(f"index values must lie in [0, {num_segments}), got [{index.min()}, {index.max()}]")
        self.index = index
        self.num_segments = num_segments
        self.num_items = int(index.size)
        self.counts = np.bincount(index, minlength=num_segments).astype(np.int64)
        self.order = np.argsort(index, kind="stable").astype(np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)[:-1]]).astype(np.int64)
        self._on: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(index, order, offsets) as int64 tensors on ``device``, copied
        there at first use and kept: a step captured in a CUDA graph then
        makes no host copy."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = tuple(torch.from_numpy(a).to(device) for a in (self.index, self.order, self.offsets))
        return self._on[key]

    def counts_on(self, device, dtype=torch.float32) -> torch.Tensor:
        """The per-segment counts as a (num_segments, 1) tensor."""
        key = f"counts {torch.device(device)} {dtype}"
        if key not in self._on:
            self._on[key] = torch.from_numpy(self.counts.reshape(-1, 1)).to(device=device, dtype=dtype)
        return self._on[key]


_CACHE: Dict[tuple, Segments] = {}
_CACHE_MAX = 512


def segments(index: IndexLike, num_segments: int) -> Segments:
    """The :class:`Segments` of ``index`` into ``num_segments`` rows, one
    per distinct pair (a :class:`Segments` is returned as it is)."""
    if isinstance(index, Segments):
        if index.num_segments != int(num_segments):
            raise ValueError(f"segments into {index.num_segments} rows used as {num_segments}")
        return index
    host = _host_index(index)
    key = (int(num_segments), host.tobytes())
    seg = _CACHE.get(key)
    if seg is None:
        if len(_CACHE) >= _CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)))
        seg = _CACHE[key] = Segments(host, num_segments)
    return seg


def _sum(data: torch.Tensor, seg: Segments) -> torch.Tensor:
    if data.shape[0] != seg.num_items:
        raise ValueError(f"segment sum of {data.shape[0]} rows over an index of {seg.num_items}")
    _, order, offsets = seg.on(data.device)
    out = F.embedding_bag(order, data.reshape(seg.num_items, -1), offsets, mode="sum")
    return out.view((seg.num_segments,) + tuple(data.shape[1:]))


def _gather(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    if x.shape[0] != seg.num_segments:
        raise ValueError(f"gather from {x.shape[0]} rows by an index into {seg.num_segments}")
    index, _, _ = seg.on(x.device)
    return x.index_select(0, index)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg):
        ctx.seg = seg
        return _sum(data, seg)

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.seg), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return _gather(x, seg)

    @staticmethod
    def backward(ctx, grad):
        return _SegmentSum.apply(grad, ctx.seg), None


def segment_sum(data: torch.Tensor, index: IndexLike, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, index, num_segments)`` in a fixed order:
    (E, ...) -> (num_segments, ...)."""
    return _SegmentSum.apply(data, segments(index, num_segments))


def gather(x: torch.Tensor, index: IndexLike) -> torch.Tensor:
    """``x[index]`` over the first axis, its backward a fixed-order segment
    sum."""
    return _Gather.apply(x, segments(index, x.shape[0]))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        ordered, order = torch.sort(index, stable=True)
        offsets = torch.searchsorted(ordered, torch.arange(ctx.num_rows, device=index.device))
        return F.embedding_bag(order, grad, offsets, mode="sum"), None


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` over the first axis of (N, C) rows, for an (M,) index
    on ``x``'s device; its backward a fixed-order sum (module docstring)."""
    return _GatherRows.apply(x, index)


def segment_sum_plain(data: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The direct version: ``zeros.index_add_(0, index, data)`` (float
    atomics on CUDA)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, index, data)


def gather_plain(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The direct version: ``x[index]`` (its backward adds with atomics on
    CUDA)."""
    return x[index]
