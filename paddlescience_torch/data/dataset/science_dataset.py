"""Scientific datasets (counterpart of
``paddlescience_tpu/data/dataset/science_dataset.py``): the ERA5-style
weather windows and the Darcy flow data generator (a numpy and scipy copy:
for one seed both give the same arrays bitwise).

``ERA5Dataset`` reads a (T, C, H, W) array from an HDF5 file through
``h5py``, imported when a file is read (the GPU machine has none), and
windows it with :func:`era5_windows`, which also takes an array in memory:
the port's FourCastNet examples build their synthetic fields in memory and
window them there, so they need no h5py.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from paddlescience_torch.data.dataset.array_dataset import NamedArrayDataset
from paddlescience_torch.data.dataset.domain_dataset import import_h5py

__all__ = ["ERA5Dataset", "era5_windows", "generate_darcy_dataset"]


def era5_windows(data: np.ndarray, input_keys: Sequence[str], label_keys: Sequence[str], size: Optional[int] = None,
                 stride: int = 1, num_label_timestamps: int = 1,
                 vars_channel: Optional[Sequence[int]] = None) -> Tuple[Dict, Dict]:
    """Autoregressive windows of a (T, C, H, W) array: input frame t, and
    for label i (of ``num_label_timestamps``) the frame t + (i + 1) stride,
    for t < min(T - stride num_label_timestamps, size); ``vars_channel``
    picks channels first. Returns (inputs, labels) as float32 dicts."""
    if vars_channel is not None:
        data = data[:, list(vars_channel)]
    if len(label_keys) != num_label_timestamps:
        raise ValueError(f"need {num_label_timestamps} label_keys, got {len(label_keys)}")
    T = data.shape[0] - stride * num_label_timestamps
    if size is not None:
        T = min(T, size)
    inputs = {input_keys[0]: data[:T].astype(np.float32)}
    labels = {key: data[stride * (i + 1): T + stride * (i + 1)].astype(np.float32)
              for i, key in enumerate(label_keys[:num_label_timestamps])}
    return inputs, labels


class ERA5Dataset(NamedArrayDataset):
    """Weather windows (:func:`era5_windows`) of the (T, C, H, W) array
    under ``hdf_key`` of the HDF5 file ``file_path``, or of ``data`` when
    given (then no file is read)."""

    def __init__(self, file_path: Optional[str], input_keys: Tuple[str, ...], label_keys: Tuple[str, ...],
                 size: Optional[int] = None, stride: int = 1, num_label_timestamps: int = 1,
                 vars_channel: Optional[Tuple[int, ...]] = None, hdf_key: str = "fields", transforms=None,
                 training: bool = True, data: Optional[np.ndarray] = None):
        if data is None:
            with import_h5py().File(file_path, "r") as f:
                data = np.asarray(f[hdf_key])
        inputs, labels = era5_windows(data, input_keys, label_keys, size, stride, num_label_timestamps, vars_channel)
        super().__init__(inputs, labels, None, transforms)
        self.input_keys = tuple(input_keys)
        self.label_keys = tuple(label_keys)


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
