"""``jax.image.resize`` in torch, with JAX's numbers.

JAX's ``"linear"`` resize samples at half-pixel centres and, when an axis
shrinks, widens the triangle kernel by the inverse scale (it antialiases):
each output sample is a normalised triangle-weighted mean of the inputs
under the widened kernel. ``F.interpolate(mode="linear",
align_corners=False)`` interpolates between the two nearest inputs only,
so it agrees when an axis grows and not when it shrinks. Here every
resized axis is one contraction with JAX's weight matrix
(``jax/_src/image/scale.py::compute_weight_mat``, built once per (in, out)
size pair in numpy and kept on each device it is used on), so both
directions give what JAX gives. ``"nearest"`` takes input floor((i + 0.5) in / out) for output
i, JAX's rule (torch's ``nearest-exact``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = ["resize", "linear_weights"]


@functools.lru_cache(maxsize=None)
def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """JAX's (n_in, n_out) triangle-kernel weights with antialiasing, in
    float32 as JAX computes them."""
    f32 = np.float32
    scale = f32(n_out) / f32(n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    offsets = (np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` "linear" (also
    "bilinear", "trilinear") or "nearest": every axis whose size changes is
    resampled."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} does not match the {x.ndim} axes of x")
    linear = method in ("linear", "bilinear", "trilinear", "triangle")
    if not linear and method != "nearest":
        raise ValueError(f"unknown resize method '{method}' (linear, nearest)")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        if linear:
            w = _on_device("linear", n_in, n_out, x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
        else:
            x = torch.index_select(x, d, _on_device("nearest", n_in, n_out, x.device, torch.int64))
    return x


_DEVICE_TABLES = {}


def _on_device(kind: str, n_in: int, n_out: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The weight matrix or index table on ``device``, copied there at its
    first use (an eager step) and kept: a step captured in a CUDA graph
    then makes no host copy."""
    key = (kind, n_in, n_out, str(device), dtype)
    if key not in _DEVICE_TABLES:
        table = linear_weights(n_in, n_out) if kind == "linear" else _nearest_index(n_in, n_out)
        _DEVICE_TABLES[key] = torch.from_numpy(table).to(device=device, dtype=dtype)
    return _DEVICE_TABLES[key]
