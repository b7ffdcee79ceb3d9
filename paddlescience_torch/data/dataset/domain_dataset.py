"""Domain datasets (counterpart of the FWI, sampled-ERA5, spherical
shallow-water, climate and nowcasting frame-window (ENSO, SEVIR) and
Transformer-PhysX trajectory (Lorenz, Rossler, cylinder) datasets of
``paddlescience_tpu/data/dataset/domain_dataset.py``).

Each reads its archive when given a path and otherwise builds the JAX
package's synthetic stand-in, with the same numpy generator and seed, so
the arrays are bitwise the JAX package's. Each is an indexed
``NamedArrayDataset`` (the JAX package's ``_DictDataset``; a
``BatchLoader`` walks it). HDF5 archives are read through ``h5py``, imported when a
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

PEMS traffic (``PEMSDataset``) reads ``{split}.npy`` series with their
``mean.npy``/``std.npy`` or synthesizes daily-periodic sensor series, cut
into input_len -> label_len windows (inputs standard-scaled). The graph
sets (``MeshAirfoilDataset``, ``MeshCylinderDataset``,
``GridMeshAtmosphericDataset``) give one graph a sample, ``(node_fea,
edge_fea, senders, receivers)`` under the input key, from .npz files or
the JAX package's synthetic kNN and lat-lon ring graphs; ``CGCNNDataset``
gives crystals ``(atom_fea, nbr_fea, nbr_idx)`` and a target.
``ChipHeatDataset`` indexes the cartesian product of its ``index``
factors (chip_heat's points x power maps x boundary types x boundary
data). Every
dataset applies its ``transforms`` to each batch it gives, as the JAX
package's.
"""

from __future__ import annotations

import glob as _glob
import os.path as osp
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from paddlescience_torch.data.dataset.array_dataset import NamedArrayDataset

__all__ = ["FWIDataset", "ERA5SampledDataset", "SphericalSWEDataset", "ENSODataset", "ExtMoEENSODataset",
           "SEVIRDataset", "LorenzDataset", "RosslerDataset", "CylinderDataset", "PEMSDataset", "make_synthetic_graph",
           "MeshAirfoilDataset", "MeshCylinderDataset", "GridMeshAtmosphericDataset", "CGCNNDataset", "ChipHeatDataset",
           "import_h5py"]

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


# ---------------------------------------------------------------------------
# Traffic (PEMS): standard-scaled sliding windows
# ---------------------------------------------------------------------------


class PEMSDataset(NamedArrayDataset):
    """PEMS traffic windows (reference ``pems_dataset.py:60-140``): a
    ``file_path`` directory with ``{split}.npy`` (T, N) and ``mean.npy`` /
    ``std.npy``, or the synthetic series (one sensor network: per-node base
    levels from seed 11, a daily sine, noise from seed 17 (train) or 18,
    the val split continuing the clock after the train window). Inputs are
    standard-scaled (``norm_input``), labels raw; ``.mean``/``.std`` are
    kept."""

    def __init__(self, input_keys: Tuple[str, ...], label_keys: Tuple[str, ...], file_path: Optional[str] = None,
                 split: str = "train", input_len: int = 12, label_len: int = 12, num_nodes: int = 8,
                 num_steps: int = 288, norm_input: bool = True, weight_dict=None, transforms=None,
                 synthetic: bool = False):
        path = _require(file_path, synthetic)
        if path is not None:
            series = np.load(osp.join(path, f"{split}.npy")).astype(_F32)
            self.mean = np.load(osp.join(path, "mean.npy")).astype(_F32)
            self.std = np.load(osp.join(path, "std.npy")).astype(_F32)
        else:
            rng = np.random.default_rng(11)
            base = rng.uniform(100, 500, num_nodes)[None, :]
            offset = 0 if split == "train" else 7 * num_steps
            t = np.arange(offset, offset + num_steps, dtype=_F32)
            daily = np.sin(2 * np.pi * t / 288.0)[:, None]
            noise_rng = np.random.default_rng(17 + (0 if split == "train" else 1))
            series = base * (1.0 + 0.5 * daily) + 10.0 * noise_rng.standard_normal(
                (num_steps, num_nodes)).astype(_F32)
            self.mean = series.mean(axis=0, keepdims=True)
            self.std = series.std(axis=0, keepdims=True) + 1e-8
        xs, ys = [], []
        total = input_len + label_len
        for i in range(0, len(series) - total + 1):
            xs.append(series[i: i + input_len])
            ys.append(series[i + input_len: i + total])
        x = np.stack(xs).astype(_F32)
        y = np.stack(ys).astype(_F32)
        if norm_input:
            x = (x - self.mean[None]) / self.std[None]
        label = {label_keys[0]: y}
        super().__init__({input_keys[0]: x}, label, _expand_weight(weight_dict, label), transforms)


# ---------------------------------------------------------------------------
# Graph datasets (AMGNet / CFDGCN / GraphCast)
# ---------------------------------------------------------------------------


def make_synthetic_graph(rng, n_nodes=64, k=4, node_dim=5, edge_dim=3, label_dim=3):
    """A kNN graph over random 2-D points -> (node_fea, edge_fea, senders,
    receivers, labels): each node sends to its k nearest; edges carry the
    offset and its length; labels are a smooth function of position."""
    pos = rng.uniform(0, 1, (n_nodes, 2)).astype(_F32)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :k]
    senders = np.repeat(np.arange(n_nodes), k).astype(np.int32)
    receivers = nbr.reshape(-1).astype(np.int32)
    rel = pos[receivers] - pos[senders]
    dist = np.linalg.norm(rel, axis=1, keepdims=True)
    edge_fea = np.concatenate([rel, dist], axis=1).astype(_F32)
    if edge_dim > 3:
        edge_fea = np.concatenate([edge_fea, np.zeros((len(edge_fea), edge_dim - 3), _F32)], axis=1)
    else:
        edge_fea = edge_fea[:, :edge_dim]
    extra = rng.standard_normal((n_nodes, max(node_dim - 2, 0))).astype(_F32) * 0.1
    node_fea = np.concatenate([pos, extra], axis=1)[:, :node_dim].astype(_F32)
    lab = np.stack([np.sin(2 * np.pi * pos[:, 0] * (j + 1)) * np.cos(2 * np.pi * pos[:, 1])
                    for j in range(label_dim)], axis=1).astype(_F32)
    return node_fea, edge_fea, senders, receivers, lab


class _GraphDataset:
    """Graph samples: input[key] = (node_fea, edge_fea, senders, receivers),
    from ``*.npz`` files (nodes, edges, senders, receivers, label) under
    ``data_dir`` or ``num_samples`` synthetic kNN graphs (seed 14)."""

    batch_mode = "indexed"
    _node_dim = 5
    _edge_dim = 3
    _label_dim = 3

    def __init__(self, input_keys: Tuple[str, ...], label_keys: Tuple[str, ...], data_dir: Optional[str] = None,
                 num_samples: int = 8, n_nodes: int = 64, k: int = 4, transforms=None, synthetic: bool = False):
        path = _require(data_dir, synthetic)
        self.input_keys = input_keys
        self.label_keys = label_keys
        self.transforms = transforms
        self.graphs = []
        if path is not None:
            for f in sorted(_glob.glob(osp.join(path, "*.npz")))[:num_samples]:
                z = np.load(f)
                self.graphs.append(((z["nodes"].astype(_F32), z["edges"].astype(_F32),
                                     z["senders"].astype(np.int32), z["receivers"].astype(np.int32)),
                                    z["label"].astype(_F32)))
            if not self.graphs:
                raise FileNotFoundError(f"no graph .npz files under '{path}'")
        else:
            rng = np.random.default_rng(14)
            for _ in range(num_samples):
                nf, ef, s, r, lab = make_synthetic_graph(rng, n_nodes, k, self._node_dim, self._edge_dim,
                                                         self._label_dim)
                self.graphs.append(((nf, ef, s, r), lab))

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, idx):
        if not np.isscalar(idx):
            idx = int(np.atleast_1d(np.asarray(idx))[0])
        graph, lab = self.graphs[idx]
        inp = {self.input_keys[0]: graph}
        label = {self.label_keys[0]: lab} if self.label_keys else {}
        wgt = {}
        if self.transforms is not None:
            inp, label, wgt = self.transforms(inp, label, wgt)
        return inp, label, wgt


class MeshAirfoilDataset(_GraphDataset):
    """Airfoil mesh graphs (reference ``airfoil_dataset.py:50-210``): 5
    node features, 3 edge features, 3 fields."""

    _node_dim, _edge_dim, _label_dim = 5, 3, 3


class MeshCylinderDataset(_GraphDataset):
    """Cylinder mesh graphs (reference ``cylinder_dataset.py:40-190``): 4
    node features, 3 edge features, 3 fields."""

    _node_dim, _edge_dim, _label_dim = 4, 3, 3


class GridMeshAtmosphericDataset(_GraphDataset):
    """GraphCast grid graphs (reference ``atmospheric_dataset.py``): a
    ``lat`` x ``lon`` grid, each point linked to its four neighbours
    (longitude periodic), 8 atmospheric channels a node; the label is the
    next state ``0.9 x + 0.1 tanh(x rolled by one node)`` (seed 15)."""

    _node_dim, _edge_dim, _label_dim = 8, 4, 8

    def __init__(self, input_keys: Tuple[str, ...], label_keys: Tuple[str, ...], data_dir: Optional[str] = None,
                 num_samples: int = 4, lat: int = 8, lon: int = 16, transforms=None, synthetic: bool = False):
        if _require(data_dir, synthetic) is not None:
            super().__init__(input_keys, label_keys, data_dir, num_samples, transforms=transforms)
            return
        self.input_keys = input_keys
        self.label_keys = label_keys
        self.transforms = transforms
        self.graphs = []
        rng = np.random.default_rng(15)
        la = np.linspace(-np.pi / 2, np.pi / 2, lat, dtype=_F32)
        lo = np.linspace(0, 2 * np.pi, lon, endpoint=False, dtype=_F32)
        LA, LO = np.meshgrid(la, lo, indexing="ij")
        pos = np.stack([LA.ravel(), LO.ravel()], 1)
        n = lat * lon
        senders, receivers = [], []
        for i in range(lat):
            for j in range(lon):
                u = i * lon + j
                for di, dj in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                    ii, jj = i + di, (j + dj) % lon
                    if 0 <= ii < lat:
                        senders.append(u)
                        receivers.append(ii * lon + jj)
        senders = np.asarray(senders, np.int32)
        receivers = np.asarray(receivers, np.int32)
        rel = pos[receivers] - pos[senders]
        ef = np.concatenate([rel, np.cos(rel)], axis=1).astype(_F32)[:, : self._edge_dim]
        if ef.shape[1] < self._edge_dim:
            ef = np.concatenate([ef, np.zeros((len(ef), self._edge_dim - ef.shape[1]), _F32)], 1)
        for _ in range(num_samples):
            state = rng.standard_normal((n, self._node_dim)).astype(_F32)
            nxt = 0.9 * state + 0.1 * np.tanh(state[np.roll(np.arange(n), 1)])
            self.graphs.append(((state, ef, senders, receivers), nxt.astype(_F32)))


# ---------------------------------------------------------------------------
# Crystal graphs (CGCNN)
# ---------------------------------------------------------------------------


class CGCNNDataset:
    """Crystal graphs (reference ``cgcnn_dataset.py``): preprocessed
    ``*.npz`` (atom_fea, nbr_fea, nbr_idx, target) under ``data_dir``, or
    ``num_samples`` synthetic periodic crystals (seed 16): binary atom
    features, the ``max_nbr`` nearest neighbours under the minimum-image
    distance, Gaussian-expanded distances, a target from both.
    ``items[i] = ((atom_fea (n, A), nbr_fea (n, M, B), nbr_idx (n, M)),
    target)``; a sample is ``({"i": (a, n, idx)}, {"out": [target]}, {})``."""

    batch_mode = "indexed"

    def __init__(self, data_dir: Optional[str] = None, num_samples: int = 16, n_atoms: int = 12,
                 atom_fea_len: int = 16, nbr_fea_len: int = 8, max_nbr: int = 8, transforms=None,
                 synthetic: bool = False):
        path = _require(data_dir, synthetic)
        self.items = []
        self.transforms = transforms
        if path is not None:
            for f in sorted(_glob.glob(osp.join(path, "*.npz")))[:num_samples]:
                z = np.load(f)
                self.items.append(((z["atom_fea"].astype(_F32), z["nbr_fea"].astype(_F32),
                                    z["nbr_idx"].astype(np.int32)), float(z["target"])))
            if not self.items:
                raise FileNotFoundError(f"no crystal .npz files under '{path}'")
        else:
            rng = np.random.default_rng(16)
            for _ in range(num_samples):
                atom_fea = (rng.integers(0, 2, (n_atoms, atom_fea_len))).astype(_F32)
                pos = rng.uniform(0, 1, (n_atoms, 3))
                d = np.linalg.norm((pos[:, None, :] - pos[None, :, :] + 0.5) % 1.0 - 0.5, axis=-1)
                np.fill_diagonal(d, np.inf)
                nbr_idx = np.argsort(d, axis=1)[:, :max_nbr].astype(np.int32)
                dist = np.take_along_axis(d, nbr_idx, axis=1)
                centers = np.linspace(0, 1.0, nbr_fea_len)
                nbr_fea = np.exp(-((dist[..., None] - centers) ** 2) / 0.02).astype(_F32)
                target = float(atom_fea.mean() + 0.5 * dist.mean())
                self.items.append(((atom_fea, nbr_fea, nbr_idx), target))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        if not np.isscalar(idx):
            idx = int(np.atleast_1d(np.asarray(idx))[0])
        (a, n, i), y = self.items[idx]
        inp = {"i": (a, n, i)}
        lab = {"out": np.asarray([y], _F32)}
        wgt = {}
        if self.transforms is not None:
            inp, lab, wgt = self.transforms(inp, lab, wgt)
        return inp, lab, wgt


class ChipHeatDataset:
    """Cartesian-product indexing over input factor arrays: ``index`` names
    the factor keys (the first varies fastest), and the dataset's length is
    the product of their lengths. A key that is a factor takes its own
    sub-index; a key as long as the product the flat index; a key as long
    as a factor that factor's sub-index (the first such factor); ``u_one``,
    when ``data_type`` is a factor, the composite index
    len(input[data_type]) * sub[index[0]] + sub[data_type] (one value per
    pair of a point and a ``data_type`` sample). Labels and weights are
    indexed by the flat index modulo their length (a single row
    repeated)."""

    batch_mode = "indexed"

    def __init__(self, input: Dict, label: Dict, index: Tuple[str, ...], data_type: str = "",
                 weight: Optional[Dict] = None, transforms=None):
        self.input = {k: np.asarray(v) for k, v in input.items()}
        self.label = {k: np.asarray(v) for k, v in (label or {}).items()}
        self.weight = {k: np.asarray(v) for k, v in (weight or {}).items()}
        self.index = tuple(index)
        self.data_type = data_type
        self.transforms = transforms
        self._sizes = [len(self.input[k]) for k in self.index]
        self._len = int(np.prod(self._sizes))

    def __len__(self):
        return self._len

    def _sub_indices(self, flat):
        subs, rem = {}, flat
        for k, sz in zip(self.index, self._sizes):
            subs[k] = rem % sz
            rem = rem // sz
        return subs

    def __getitem__(self, idx):
        scalar = np.isscalar(idx) or (isinstance(idx, np.ndarray) and idx.ndim == 0)
        flat = np.atleast_1d(np.asarray(idx))
        subs = self._sub_indices(flat)
        len_by_size = {}
        for k in self.index:
            len_by_size.setdefault(len(self.input[k]), k)
        inp = {}
        for k, v in self.input.items():
            if k == "u_one" and self.data_type in subs and self.index and self.index[0] in subs:
                inp[k] = v[len(self.input[self.data_type]) * subs[self.index[0]] + subs[self.data_type]]
            elif k in subs:
                inp[k] = v[subs[k]]
            elif len(v) == self._len:
                inp[k] = v[flat]
            elif len(v) in len_by_size:
                inp[k] = v[subs[len_by_size[len(v)]]]
            else:
                raise ValueError(f"input '{k}' length {len(v)} matches neither a factor nor the product")
        lab = {k: (v[flat % len(v)] if len(v) > 1 else np.repeat(v, len(flat), 0)) for k, v in self.label.items()}
        wgt = {k: v[flat % len(v)] for k, v in self.weight.items()}
        if scalar:
            inp, lab, wgt = ({k: v[0] for k, v in d.items()} for d in (inp, lab, wgt))
        if self.transforms is not None:
            inp, lab, wgt = self.transforms(inp, lab, wgt)
        return inp, lab, wgt
