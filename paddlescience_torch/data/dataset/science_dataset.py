"""The Darcy flow data generator (counterpart of
``paddlescience_tpu/data/dataset/science_dataset.py::generate_darcy_dataset``,
a numpy and scipy copy: for one seed both give the same arrays bitwise)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["generate_darcy_dataset"]


def generate_darcy_dataset(n_samples: int = 64, resolution: int = 64, seed: int = 0, alpha: float = 2.0,
                           tau: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """(permeability a, solution u) pairs of 2-D Darcy flow -div(a grad u)
    = 1 on (0, 1)^2 with u = 0 on the boundary: a = exp of a Gaussian random
    field sampled spectrally (covariance (tau^2 (-Laplacian + tau^2))^-alpha,
    from ``np.random.default_rng(seed)``), u from a 5-point finite-difference
    scheme (scipy sparse LU). Returns a and u of shape (N, 1, R, R), float32."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(seed)
    R = resolution
    k = np.fft.fftfreq(R, d=1.0 / R)
    KX, KY = np.meshgrid(k, k, indexing="ij")
    spectrum = (4 * np.pi**2 * (KX**2 + KY**2) + tau**2) ** (-alpha / 2)
    spectrum[0, 0] = 0.0

    a_all, u_all = [], []
    h = 1.0 / (R + 1)
    for _ in range(n_samples):
        noise = rng.normal(size=(R, R)) + 1j * rng.normal(size=(R, R))
        grf = np.real(np.fft.ifft2(noise * spectrum)) * R
        a = np.exp(grf / max(np.abs(grf).std(), 1e-9))

        # 5-point stencil of -div(a grad u) = 1, u = 0 on a ghost boundary
        N = R * R
        idx = np.arange(N).reshape(R, R)
        rows, cols, vals = [], [], []
        b = np.ones(N)
        for i in range(R):
            for j in range(R):
                c = idx[i, j]
                diag = 0.0
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    ni, nj = i + di, j + dj
                    if 0 <= ni < R and 0 <= nj < R:
                        w = 0.5 * (a[i, j] + a[ni, nj]) / h**2
                        rows.append(c)
                        cols.append(idx[ni, nj])
                        vals.append(-w)
                        diag += w
                    else:
                        diag += a[i, j] / h**2
                rows.append(c)
                cols.append(c)
                vals.append(diag)
        A = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
        u = spla.spsolve(A, b).reshape(R, R)
        a_all.append(a)
        u_all.append(u)
    return np.asarray(a_all, np.float32)[:, None], np.asarray(u_all, np.float32)[:, None]
