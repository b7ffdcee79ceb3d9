"""Domain datasets of the neural-operator examples (counterpart of the
FWI, sampled-ERA5 and spherical shallow-water datasets of
``paddlescience_tpu/data/dataset/domain_dataset.py``).

Each reads its archive when given a path and otherwise builds the JAX
package's synthetic stand-in, with the same numpy generator and seed, so
the arrays are bitwise the JAX package's. Each is an indexed
``NamedArrayDataset`` (a ``BatchLoader`` walks it); per-dataset transforms
are not ported. HDF5 archives are read through ``h5py``, imported when a
file is read: a machine without it (the GPU machine has none) can still
build every synthetic set, and a file read there raises naming h5py.
"""

from __future__ import annotations

import glob as _glob
import os.path as osp
from typing import Optional, Tuple

import numpy as np

from paddlescience_torch.data.dataset.array_dataset import NamedArrayDataset

__all__ = ["FWIDataset", "ERA5SampledDataset", "SphericalSWEDataset", "import_h5py"]

_F32 = np.float32


def import_h5py():
    """``h5py``, or an ImportError naming it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading an HDF5 archive needs h5py, which is not installed here; build the "
                          "dataset from its synthetic branch (no file path) or from arrays in memory") from e
    return h5py


def _require(path: Optional[str], synthetic: bool) -> Optional[str]:
    """The data source: a real path, or None meaning 'synthesize'."""
    if synthetic or path is None:
        return None
    if not osp.exists(path):
        raise FileNotFoundError(f"dataset path '{path}' does not exist; pass file_path=None (or synthetic=True) "
                                "to use the synthetic generator instead")
    return path


def _expand_weight(weight_dict, label):
    if not weight_dict:
        return {}
    n = len(next(iter(label.values())))
    return {k: np.full((n, 1), v, _F32) for k, v in weight_dict.items()}


class ERA5SampledDataset(NamedArrayDataset):
    """Pre-sampled ERA5 pairs: a directory of .h5 files, each holding
    "input" and "label" arrays; synthetic: ``num_samples`` standard normal
    (C, H, W) pairs."""

    def __init__(self, file_path: Optional[str], input_keys: Tuple[str, ...], label_keys: Tuple[str, ...],
                 num_samples: int = 4, C: int = 2, H: int = 16, W: int = 32, weight_dict=None, transforms=None,
                 synthetic: bool = False):
        path = _require(file_path, synthetic)
        xs, ys = [], []
        if path is not None:
            h5py = import_h5py()
            files = sorted(_glob.glob(osp.join(path, "*.h5")))
            if not files:
                raise FileNotFoundError(f"no sampled ERA5 .h5 files under '{path}'")
            for p in files:
                with h5py.File(p, "r") as f:
                    xs.append(np.asarray(f["input"], _F32))
                    ys.append(np.asarray(f["label"], _F32))
        else:
            rng = np.random.default_rng(9)
            for _ in range(num_samples):
                xs.append(rng.standard_normal((C, H, W)).astype(_F32))
                ys.append(rng.standard_normal((C, H, W)).astype(_F32))
        label = {label_keys[0]: np.stack(ys)}
        super().__init__({input_keys[0]: np.stack(xs)}, label, _expand_weight(weight_dict, label), transforms)


class FWIDataset(NamedArrayDataset):
    """OpenFWI seismic -> velocity pairs. Real layout: ``anno_file`` lines
    of "data.npy label.npy" ((B, C, H, W) arrays, the data subsampled in
    time by ``sample_ratio``). Synthetic: layered, tilted velocity maps
    (3-6 layers) and, as their "recorded data", the vertical difference of
    the slowness plus 1% noise."""

    def __init__(self, input_keys: Tuple[str, ...], label_keys: Tuple[str, ...], anno_file: Optional[str] = None,
                 num_samples: int = 16, sample_ratio: int = 1, H: int = 32, W: int = 32, weight_dict=None,
                 transforms=None, synthetic: bool = False):
        path = _require(anno_file, synthetic)
        if path is not None:
            datas, labels = [], []
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    datas.append(np.load(parts[0])[:, :, ::sample_ratio, :].astype(_F32))
                    if len(parts) > 1:
                        labels.append(np.load(parts[1]).astype(_F32))
            x = np.concatenate(datas)
            y = np.concatenate(labels) if labels else None
        else:
            rng = np.random.default_rng(10)
            vel = np.zeros((num_samples, 1, H, W), _F32)
            for i in range(num_samples):
                n_layers = rng.integers(3, 7)
                depths = np.sort(rng.uniform(0, H, n_layers - 1)).astype(int)
                v = np.cumsum(rng.uniform(0.2, 1.0, n_layers)) + 1.5
                row = np.zeros(H, _F32)
                prev = 0
                for d, vv in zip(list(depths) + [H], v):
                    row[prev:d] = vv
                    prev = d
                tilt = rng.uniform(-0.3, 0.3)
                for col in range(W):
                    vel[i, 0, :, col] = np.roll(row, int(tilt * (col - W / 2)))
            y = vel
            slow = 1.0 / vel
            x = np.diff(slow, axis=2, prepend=slow[:, :, :1])
            x = x + 0.01 * rng.standard_normal(x.shape).astype(_F32)
        label = {label_keys[0]: y} if y is not None else {}
        super().__init__({input_keys[0]: x}, label, _expand_weight(weight_dict, label), transforms)


class SphericalSWEDataset(NamedArrayDataset):
    """Spherical shallow-water pairs. Real layout:
    ``data_dir/{train,test}_SWE_{resolution}.npy``, a pickled dict {"x",
    "y"} of (N, 3, H, W). Synthetic: three band-limited fields a sample,
    advanced by rotating each latitude ring by 3 cos(latitude) cells."""

    def __init__(self, input_keys: Tuple[str, ...], label_keys: Tuple[str, ...], data_dir: Optional[str] = None,
                 data_split: str = "train", resolution: str = "32x64", num_samples: int = 16, H: int = 32,
                 W: int = 64, weight_dict=None, transforms=None, synthetic: bool = False):
        path = _require(data_dir, synthetic)
        if path is not None:
            prefix = "train" if data_split == "train" else "test"
            fname = osp.join(path, f"{prefix}_SWE_{resolution}.npy")
            if not osp.exists(fname):
                raise FileNotFoundError(fname)
            d = np.load(fname, allow_pickle=True).item()
            x, y = np.asarray(d["x"], _F32), np.asarray(d["y"], _F32)
        else:
            rng = np.random.default_rng(12 if data_split == "train" else 13)
            lat = np.linspace(-np.pi / 2, np.pi / 2, H, dtype=_F32)
            x = np.zeros((num_samples, 3, H, W), _F32)
            for i in range(num_samples):
                for c in range(3):
                    for k in range(1, 4):
                        ph = rng.uniform(0, 2 * np.pi, 2)
                        la = np.linspace(0, np.pi, H, dtype=_F32)
                        lo = np.linspace(0, 2 * np.pi, W, dtype=_F32)
                        x[i, c] += rng.uniform(0.2, 1.0) * np.outer(np.sin(k * la + ph[0]), np.cos(k * lo + ph[1]))
            shift = (3.0 * np.cos(lat)).astype(int)
            y = np.empty_like(x)
            for j in range(H):
                y[:, :, j, :] = np.roll(x[:, :, j, :], shift[j], axis=-1)
        label = {label_keys[0]: y}
        super().__init__({input_keys[0]: x}, label, _expand_weight(weight_dict, label), transforms)
