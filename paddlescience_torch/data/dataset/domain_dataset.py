"""Domain datasets (counterpart of the FWI, sampled-ERA5, spherical
shallow-water, climate and nowcasting frame-window (ENSO, SEVIR) and
Transformer-PhysX trajectory (Lorenz, Rossler, cylinder) datasets of
``paddlescience_tpu/data/dataset/domain_dataset.py``).

Each reads its archive when given a path and otherwise builds the JAX
package's synthetic stand-in, with the same numpy generator and seed, so
the arrays are bitwise the JAX package's. Each is an indexed
``NamedArrayDataset`` (the JAX package's ``_DictDataset``; a
``BatchLoader`` walks it); per-dataset transforms
are not ported. HDF5 archives are read through ``h5py``, imported when a
file is read: a machine without it (the GPU machine has none) can still
build every synthetic set, and a file read there raises naming h5py.
The SEVIR catalog is read with pandas, imported likewise.

Frame windows (``_FrameWindowDataset``): each (T, H, W) sequence is cut
into (in_len, H, W, 1) inputs and the next (out_len, H, W, 1) labels
every ``stride`` frames (default in_len + out_len). ENSO reads the CMIP
archive directory (``CMIP_train.nc``/``CMIP_label.nc``: per-model year
folding, 95E..330E) or a flat sst array; its synthetic stand-in is four
spectral modes. SEVIR reads the CATALOG.csv layout or .h5 files of (N, H,
W, T) events, preprocessed as ``scale * (x + offset)``; its stand-in is
advecting Gaussian rain cells. The trajectory sets window HDF5 groups of
(T, D) series (or RK4 trajectories of the Lorenz and Rossler systems) into
(block_size, D) windows, labels ``window[1:]`` and ``window``; given an
``embedding_model`` they hold its encoder's embeddings of the windows
instead (the transformer stage).
"""

from __future__ import annotations

import glob as _glob
import os.path as osp
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from paddlescience_torch.data.dataset.array_dataset import NamedArrayDataset

__all__ = ["FWIDataset", "ERA5SampledDataset", "SphericalSWEDataset", "ENSODataset", "ExtMoEENSODataset",
           "SEVIRDataset", "LorenzDataset", "RosslerDataset", "CylinderDataset", "import_h5py"]

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


# ------------------------------------------- Transformer-PhysX trajectories --


def _rk4(f, y0, dt, n):
    ys = np.empty((n,) + np.shape(y0), np.float64)
    y = np.asarray(y0, np.float64)
    for i in range(n):
        k1 = f(y)
        k2 = f(y + 0.5 * dt * k1)
        k3 = f(y + 0.5 * dt * k2)
        k4 = f(y + dt * k3)
        y = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        ys[i] = y
    return ys


def _window_series(series_list, block_size, stride):
    longest = max(len(s) for s in series_list)
    if block_size > longest:
        raise ValueError(f"block_size={block_size} exceeds the longest trajectory ({longest} steps)")
    blocks = []
    for s in series_list:
        for i in range(0, len(s) - block_size + 1, stride):
            blocks.append(s[i: i + block_size])
    return np.stack(blocks).astype(_F32)


class _TrajectoryWindowDataset(NamedArrayDataset):
    """HDF5 groups of (T, D) series -> (block_size, D) windows; labels
    ``window[1:]`` and ``window``."""

    def __init__(self, file_path: Optional[str], input_keys: Tuple[str, ...], label_keys: Tuple[str, ...],
                 block_size: int, stride: int, ndata: Optional[int] = None,
                 weight_dict: Optional[Dict[str, float]] = None, transforms=None, synthetic: bool = False,
                 embedding_model=None):
        path = _require(file_path, synthetic)
        series = self._read_h5(path, ndata) if path is not None else self._synthesize(ndata or 8)
        data = _window_series(series, block_size, stride)
        if embedding_model is not None:  # the transformer stage: the embedding model's encodings of the windows
            import torch

            device = next(embedding_model.parameters()).device
            with torch.no_grad():
                emb = embedding_model.encoder(torch.from_numpy(data.reshape(-1, data.shape[-1])).to(device))
            data = emb.cpu().numpy().reshape(data.shape[0], data.shape[1], -1).astype(_F32)
        label = {}
        if len(label_keys) > 0:
            label[label_keys[0]] = data[:, 1:]
        if len(label_keys) > 1:
            label[label_keys[1]] = data
        super().__init__({input_keys[0]: data}, label, _expand_weight(weight_dict, label), transforms)

    @staticmethod
    def _read_h5(path, ndata):
        h5py = import_h5py()
        series = []
        with h5py.File(path, "r") as f:
            for key in f.keys():
                series.append(np.asarray(f[key]))
                if ndata is not None and len(series) >= ndata:
                    break
        if not series:
            raise ValueError(f"HDF5 file '{path}' contains no trajectory groups")
        return series

    def _synthesize(self, ndata):
        raise NotImplementedError


class LorenzDataset(_TrajectoryWindowDataset):
    """Lorenz-63 trajectory windows; synthetic: RK4 at dt 0.01, 320 steps
    from a uniform start, the first 64 dropped."""

    def _synthesize(self, ndata):
        rng = np.random.default_rng(0)
        out = []
        for _ in range(ndata):
            y0 = rng.uniform(-10, 10, 3) + np.array([0.0, 0.0, 25.0])

            def f(y):
                return np.array([10.0 * (y[1] - y[0]), y[0] * (28.0 - y[2]) - y[1], y[0] * y[1] - 8.0 / 3.0 * y[2]])

            out.append(_rk4(f, y0, 0.01, 320)[64:])
        return out


class RosslerDataset(_TrajectoryWindowDataset):
    """Rossler (a = b = 0.2, c = 5.7) trajectory windows; synthetic: RK4
    at dt 0.05, 320 steps, the first 64 dropped."""

    def _synthesize(self, ndata):
        rng = np.random.default_rng(1)
        out = []
        for _ in range(ndata):
            y0 = rng.uniform(-5, 5, 3)

            def f(y):
                return np.array([-y[1] - y[2], y[0] + 0.2 * y[1], 0.2 + y[2] * (y[0] - 5.7)])

            out.append(_rk4(f, y0, 0.05, 320)[64:])
        return out


class CylinderDataset(NamedArrayDataset):
    """Flow-past-cylinder field windows (T, 3, H, W) with each
    trajectory's viscosity; synthetic: travelling waves whose speed
    depends on the viscosity."""

    def __init__(self, file_path: Optional[str], input_keys: Tuple[str, ...], label_keys: Tuple[str, ...],
                 block_size: int, stride: int, ndata: Optional[int] = None, H: int = 16, W: int = 32,
                 weight_dict: Optional[Dict[str, float]] = None, transforms=None, synthetic: bool = False):
        path = _require(file_path, synthetic)
        fields, viscs = [], []
        if path is not None:
            h5py = import_h5py()
            with h5py.File(path, "r") as f:
                for key in f.keys():
                    g = f[key]
                    if isinstance(g, h5py.Group):
                        fields.append(np.asarray(g["fields" if "fields" in g else "x"]))
                        viscs.append(float(np.asarray(g["visc"])) if "visc" in g else 1e-3)
                    else:
                        fields.append(np.asarray(g))
                        viscs.append(1e-3)
                    if ndata is not None and len(fields) >= ndata:
                        break
        else:
            rng = np.random.default_rng(2)
            yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 2, W), indexing="ij")
            for _ in range(ndata or 4):
                visc = 10.0 ** rng.uniform(-4, -2)
                speed = 1.0 + 100.0 * visc
                t = np.arange(96)[:, None, None] * 0.05 * speed
                u = np.sin(2 * np.pi * (xx[None] - t)) * np.exp(-((yy[None] - 0.5) ** 2) / 0.1)
                v = 0.5 * np.cos(2 * np.pi * (xx[None] - t)) * (yy[None] - 0.5)
                p = 0.25 * np.sin(4 * np.pi * (xx[None] - t))
                fields.append(np.stack([u, v, p], axis=1))
                viscs.append(visc)
        blocks, visc_rep = [], []
        for fld, vc in zip(fields, viscs):
            for i in range(0, len(fld) - block_size + 1, stride):
                blocks.append(fld[i: i + block_size])
                visc_rep.append(vc)
        data = np.stack(blocks).astype(_F32)
        inputs = {input_keys[0]: data}
        if len(input_keys) > 1:
            inputs[input_keys[1]] = np.asarray(visc_rep, _F32)[:, None]
        label = {}
        if len(label_keys) > 0:
            label[label_keys[0]] = data[:, 1:]
        if len(label_keys) > 1:
            label[label_keys[1]] = data
        super().__init__(inputs, label, _expand_weight(weight_dict, label), transforms)


# ------------------------------------------ climate and nowcasting windows --


def _advecting_cells(rng, T, H, W, n_cells=4):
    """Synthetic nowcasting frames: Gaussian rain cells advecting with a
    velocity each, their intensity decaying over time."""
    yy, xx = np.meshgrid(np.arange(H, dtype=_F32), np.arange(W, dtype=_F32), indexing="ij")
    frames = np.zeros((T, H, W), _F32)
    cy = rng.uniform(0, H, n_cells)
    cx = rng.uniform(0, W, n_cells)
    vy = rng.uniform(-1.0, 1.0, n_cells)
    vx = rng.uniform(-1.5, 1.5, n_cells)
    amp = rng.uniform(0.5, 1.0, n_cells)
    sig = rng.uniform(H / 12, H / 5, n_cells)
    for t in range(T):
        for c in range(n_cells):
            py = (cy[c] + vy[c] * t) % H
            px = (cx[c] + vx[c] * t) % W
            frames[t] += amp[c] * np.exp(-(((yy - py) ** 2 + (xx - px) ** 2) / (2 * sig[c] ** 2))) * (0.97**t)
    return np.clip(frames, 0.0, 1.0)


class _FrameWindowDataset(NamedArrayDataset):
    """(in_len, H, W, 1) inputs -> the next (out_len, H, W, 1) frames,
    from a list of (T, H, W) sequences."""

    def __init__(self, input_keys, label_keys, frames, in_len, out_len, stride=None, weight_dict=None,
                 transforms=None):
        stride = stride or (in_len + out_len)
        total = in_len + out_len
        xs, ys = [], []
        for seq in frames:
            for i in range(0, len(seq) - total + 1, stride):
                xs.append(seq[i: i + in_len])
                ys.append(seq[i + in_len: i + total])
        x = np.stack(xs)[..., None].astype(_F32)
        y = np.stack(ys)[..., None].astype(_F32)
        label = {label_keys[0]: y}
        super().__init__({input_keys[0]: x}, label, _expand_weight(weight_dict, label), transforms)


def _cmip_fold(d: np.ndarray, size: int = 36, stride: int = 12) -> np.ndarray:
    """Per-year 36-month windows (years, 36, ...) stitched back into one
    monthly series ((years - 1) * stride + size, ...)."""
    y = d.shape[0]
    out = np.empty(((y - 1) * stride + size,) + d.shape[2:], d.dtype)
    for i in range(y):
        out[i * stride: i * stride + size] = d[i]
    return out


def _read_cmip_dir(dir_path: str, cmip6_rows: int, years6: int, years5: int):
    """The CMIP archive directory: ``CMIP_train.nc`` (sst (rows, 36, lat,
    lon), a ``lon`` coordinate selecting 95E..330E) and ``CMIP_label.nc``
    (nino (rows, 36)); the first ``cmip6_rows`` year-rows are CMIP6 runs
    of ``years6`` years each, the rest CMIP5 runs of ``years5``. Returns
    per-model monthly sst series and nino series (or None)."""
    h5py = import_h5py()
    with h5py.File(osp.join(dir_path, "CMIP_train.nc"), "r") as f:
        sst = np.asarray(f["sst"], _F32)
        lon_coord = np.asarray(f["lon"]) if "lon" in f else None
    nino = None
    lbl = osp.join(dir_path, "CMIP_label.nc")
    if osp.exists(lbl):
        with h5py.File(lbl, "r") as f:
            nino = np.asarray(f["nino"], _F32)
    if lon_coord is not None and lon_coord.shape[0] == sst.shape[-1]:
        sst = sst[..., np.logical_and(lon_coord >= 95, lon_coord <= 330)]

    def split(rows6, ypm6, ypm5, data):
        groups = []
        for block, ypm in ((data[:rows6], ypm6), (data[rows6:], ypm5)):
            if block.shape[0] == 0:
                continue
            if block.shape[0] % ypm:
                raise ValueError(f"CMIP block of {block.shape[0]} year-rows is not divisible by years-per-model {ypm}")
            for m in range(block.shape[0] // ypm):
                groups.append(_cmip_fold(block[m * ypm: (m + 1) * ypm]))
        return groups

    return (split(cmip6_rows, years6, years5, sst),
            split(cmip6_rows, years6, years5, nino) if nino is not None else None)


def _load_array(path, key):
    if path.endswith(".npy"):
        return np.asarray(np.load(path), _F32)
    if path.endswith(".npz"):
        z = np.load(path)
        return np.asarray(z[key] if key in z else z[list(z.keys())[0]], _F32)
    if path.endswith(".h5") or path.endswith(".hdf5"):
        h5py = import_h5py()
        with h5py.File(path, "r") as f:
            return np.asarray(f[key if key in f else list(f.keys())[0]], _F32)
    raise ValueError(f"unsupported array file '{path}'")


class ENSODataset(_FrameWindowDataset):
    """Sliding SST windows: the CMIP archive directory (windows never
    cross a model's boundary), a flat (T, lat, lon) ``sst`` array in
    .npz/.npy/.h5, or (no path) four random spectral modes over
    ``num_months``."""

    def __init__(self, input_keys: Tuple[str, ...], label_keys: Tuple[str, ...], file_path: Optional[str] = None,
                 in_len: int = 12, out_len: int = 26, lat: int = 24, lon: int = 48, num_months: int = 120,
                 stride: Optional[int] = 1, weight_dict=None, transforms=None, synthetic: bool = False,
                 cmip6_rows: int = 2265, years6: int = 151, years5: int = 140):
        path = _require(file_path, synthetic)
        if path is not None and osp.isdir(path):
            frames, _ = _read_cmip_dir(path, cmip6_rows, years6, years5)
            super().__init__(input_keys, label_keys, frames, in_len, out_len, stride, weight_dict, transforms)
            return
        if path is not None:
            sst = _load_array(path, "sst")
        else:
            rng = np.random.default_rng(3)
            t = np.arange(num_months, dtype=_F32)
            la = np.linspace(-np.pi / 2, np.pi / 2, lat, dtype=_F32)
            lo = np.linspace(0, 2 * np.pi, lon, dtype=_F32)
            sst = np.zeros((num_months, lat, lon), _F32)
            for k in range(1, 5):
                phase = rng.uniform(0, 2 * np.pi, 3)
                amp = rng.uniform(0.2, 1.0)
                sst += amp * (np.sin(k * la[None, :, None] + phase[0]) * np.cos(k * lo[None, None, :] + phase[1])
                              * np.sin(2 * np.pi * t[:, None, None] / (12.0 * k) + phase[2]))
        super().__init__(input_keys, label_keys, [sst], in_len, out_len, stride, weight_dict, transforms)


class ExtMoEENSODataset(ENSODataset):
    """ENSO windows for the MoE Earthformer (the same windows)."""


# the SEVIR preprocess x -> scale * (x + offset), by image type
_SEVIR_SCALE = {"vis": 1.0, "ir069": 1 / 1174.68, "ir107": 1 / 2562.43, "vil": 1 / 47.54, "lght": 1 / 0.60517}
_SEVIR_OFFSET = {"vis": 0.0, "ir069": 3683.58, "ir107": 1552.80, "vil": -33.44, "lght": -0.02990}


class SEVIRDataset(_FrameWindowDataset):
    """SEVIR event windows: the CATALOG.csv layout (events without
    missing data that hold every requested type, each raster read from
    data/<file_name> at <file_index>), else .h5 files of (N, H, W, T)
    events named after the type, else (no path) ``num_events`` advecting
    rain-cell sequences. Frames are (T, H, W) after ``scale * (x +
    offset)``, cropped to ``img_height`` x ``img_width``."""

    def __init__(self, input_keys: Tuple[str, ...], label_keys: Tuple[str, ...], data_dir: Optional[str] = None,
                 data_types: Sequence[str] = ("vil",), in_len: int = 13, out_len: int = 12,
                 stride: Optional[int] = None, img_height: int = 384, img_width: int = 384, num_events: int = 4,
                 preprocess: bool = True, weight_dict=None, transforms=None, synthetic: bool = False):
        path = _require(data_dir, synthetic)
        if path is not None:
            catalog = self._find_catalog(path)
            if catalog is not None:
                seqs = self._load_from_catalog(catalog, data_types, preprocess, img_height, img_width)
            else:
                seqs = self._load_flat_layout(path, data_types[0], preprocess, img_height, img_width)
        else:
            rng = np.random.default_rng(8)
            seqs = [_advecting_cells(rng, in_len + out_len, img_height, img_width) for _ in range(num_events)]
        super().__init__(input_keys, label_keys, seqs, in_len, out_len, stride, weight_dict, transforms)

    @staticmethod
    def _find_catalog(path):
        for root in (path, osp.join(path, "sevir")):
            if osp.exists(osp.join(root, "CATALOG.csv")):
                return root
        return None

    @staticmethod
    def _frames(raw, dtype_name, preprocess, img_height, img_width):
        seq = np.transpose(raw, (2, 0, 1)).astype(_F32)  # (H, W, T) -> (T, H, W)
        if preprocess:
            seq = _SEVIR_SCALE[dtype_name] * (seq + _SEVIR_OFFSET[dtype_name])
        return seq[:, :img_height, :img_width]

    @staticmethod
    def _load_from_catalog(root, data_types, preprocess, img_height, img_width):
        import pandas as pd

        h5py = import_h5py()
        catalog = pd.read_csv(osp.join(root, "CATALOG.csv"), low_memory=False)
        if "pct_missing" in catalog.columns:
            catalog = catalog[catalog.pct_missing == 0]
        imgts = set(data_types)
        filtcat = catalog[np.logical_or.reduce([catalog.img_type == i for i in data_types])]
        filtcat = filtcat.groupby("id").filter(lambda x: imgts.issubset(set(x["img_type"])))
        filtcat = filtcat.groupby("id").filter(lambda x: x.shape[0] == len(imgts))
        if filtcat.empty:
            raise FileNotFoundError(f"SEVIR catalog at '{root}' has no events with colocated img_types "
                                    f"{sorted(imgts)}")
        dtype_name = data_types[0]
        seqs, handles = [], {}
        try:
            for _, group in filtcat.groupby("id"):
                row = group.set_index("img_type").loc[dtype_name]
                if row.file_name not in handles:
                    handles[row.file_name] = h5py.File(osp.join(root, "data", row.file_name), "r")
                raw = np.asarray(handles[row.file_name][dtype_name][int(row.file_index)])
                seqs.append(SEVIRDataset._frames(raw, dtype_name, preprocess, img_height, img_width))
        finally:
            for f in handles.values():
                f.close()
        return seqs

    @staticmethod
    def _load_flat_layout(path, dtype_name, preprocess, img_height, img_width):
        h5py = import_h5py()
        files = sorted(_glob.glob(osp.join(path, "**", "*.h5"), recursive=True))
        if not files:
            raise FileNotFoundError(f"no SEVIR .h5 event files under '{path}'")
        seqs = []
        for p in files:
            with h5py.File(p, "r") as f:
                if dtype_name in f:
                    seqs.extend(SEVIRDataset._frames(ev, dtype_name, preprocess, img_height, img_width)
                                for ev in np.asarray(f[dtype_name]))
        return seqs
