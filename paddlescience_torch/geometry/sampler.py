"""Pseudo-random and low-discrepancy unit-cube samplers (counterpart of
``paddlescience_tpu/geometry/sampler.py``, host-side numpy and
``scipy.stats.qmc``)."""

from __future__ import annotations

import numpy as np

__all__ = ["sample"]

_DEFAULT_DTYPE = np.float32


def sample(n: int, ndim: int, method: str = "pseudo") -> np.ndarray:
    """Sample n points in [0, 1]^ndim.

    methods: "pseudo" (np.random), "LHS" (Latin hypercube), "Halton",
    "Hammersley" (Halton with first-dim linear sweep), "Sobol".
    """
    if method == "pseudo":
        return np.random.random(size=(n, ndim)).astype(_DEFAULT_DTYPE)
    from scipy.stats import qmc  # here, not at import: scipy.stats takes seconds to load

    if method == "LHS":
        return qmc.LatinHypercube(d=ndim).random(n).astype(_DEFAULT_DTYPE)
    if method == "Halton":
        return qmc.Halton(d=ndim, scramble=False).random(n).astype(_DEFAULT_DTYPE)
    if method == "Hammersley":
        if ndim == 1:
            return (np.arange(1, n + 1)[:, None] / (n + 1)).astype(_DEFAULT_DTYPE)
        out = np.empty((n, ndim), dtype=_DEFAULT_DTYPE)
        out[:, 0] = np.arange(1, n + 1) / (n + 1)
        out[:, 1:] = qmc.Halton(d=ndim - 1, scramble=False).random(n)
        return out
    if method == "Sobol":
        return qmc.Sobol(d=ndim, scramble=True).random(n).astype(_DEFAULT_DTYPE)
    raise ValueError(f"sampling method '{method}' not supported (pseudo/LHS/Halton/Hammersley/Sobol)")
