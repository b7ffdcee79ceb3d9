"""CViT on 2-D Navier-Stokes next-step prediction, on the port
(counterpart of ``examples/ns_cvit.py``).

``CVit`` (patch 1 x 4 x 4, grid 32 x 32, embed 96, depth 3, 4 heads)
maps a window of ``prev_steps`` (u, vx, vy) frames to the next frame at
query coordinates. The data are the PDEBench NavierStokes-2D HDF5 file at
``data_path`` when given (read with h5py, imported then), otherwise the
JAX example's pseudo-spectral vorticity solver at 32 x 32
(:func:`spectral_ns2d`, the same numpy code: RK2 with an integrating
factor, 2/3 de-aliasing). Training batches are fresh every step
(``ContinuousNamedArrayDataset``: 8 windows of the first 80%, at 256
distinct random grid points, from one numpy generator), staged into the
captured chunk's device buffers by the solver. MSE loss; AdamW at 1e-3
(weight decay 1e-5); the score ``L2Rel`` on the held-out windows at every
grid point.

Run on the GPU: ``python -m paddlescience_torch.examples.ns_cvit [epochs]``.
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.cvit import CVit
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.data.dataset.domain_dataset import import_h5py
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.optimizer import AdamW
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["spectral_ns2d", "load_data", "build_solver"]


def spectral_ns2d(n_traj=8, nt=24, n=32, nu=1e-3, seed=0):
    """Decaying 2-D turbulence: (n_traj, nt, n, n, 3) of (vorticity, vx, vy)."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(n, d=1.0 / n) * 2 * np.pi
    kx, ky = np.meshgrid(k, k, indexing="ij")
    k2 = kx**2 + ky**2
    k2_inv = np.where(k2 == 0, 1.0, 1.0 / np.where(k2 == 0, 1.0, k2))
    dealias = (np.abs(kx) < n * np.pi * 2 / 3) & (np.abs(ky) < n * np.pi * 2 / 3)
    out = np.zeros((n_traj, nt, n, n, 3), "float32")
    dt = 5e-3
    sub = 4
    for tr in range(n_traj):
        wh = np.fft.fft2(rng.standard_normal((n, n)))
        wh *= np.exp(-((np.sqrt(k2) - 2 * np.pi * 4) ** 2) / (2 * (2 * np.pi) ** 2))
        w = np.real(np.fft.ifft2(wh))
        w = w / (np.abs(w).max() + 1e-9) * 5
        wh = np.fft.fft2(w)

        def rhs(wh):
            psih = wh * k2_inv
            vx = np.real(np.fft.ifft2(1j * ky * psih))
            vy = np.real(np.fft.ifft2(-1j * kx * psih))
            wx = np.real(np.fft.ifft2(1j * kx * wh))
            wy = np.real(np.fft.ifft2(1j * ky * wh))
            return -np.fft.fft2(vx * wx + vy * wy) * dealias

        visc = np.exp(-nu * k2 * dt)
        for t in range(nt):
            psih = wh * k2_inv
            out[tr, t, :, :, 0] = np.real(np.fft.ifft2(wh))
            out[tr, t, :, :, 1] = np.real(np.fft.ifft2(1j * ky * psih))
            out[tr, t, :, :, 2] = np.real(np.fft.ifft2(-1j * kx * psih))
            for _ in range(sub):
                k1 = rhs(wh)
                wh_mid = (wh + 0.5 * dt * k1) * np.exp(-nu * k2 * dt / 2)
                k2_ = rhs(wh_mid)
                wh = wh * visc + dt * k2_ * np.exp(-nu * k2 * dt / 2)
    return out


def load_data(data_path, prev_steps, n_traj=8, seed=0):
    """(windows (B, T, H, W, C), next frames (B, H, W, C))."""
    from numpy.lib.stride_tricks import sliding_window_view

    if data_path and osp.exists(data_path):
        with import_h5py().File(data_path, "r") as f:
            grp = f["train"] if "train" in f else f
            data = np.stack([np.asarray(grp[k], "float32") for k in ("u", "vx", "vy")], -1)
    else:
        print(f"[ns_cvit] {data_path!r} absent -> pseudo-spectral 2D NS trajectories")
        data = spectral_ns2d(n_traj=n_traj, seed=seed)
    sw = np.moveaxis(sliding_window_view(data, prev_steps + 1, axis=1), -1, 2)  # (n, m, S, H, W, C)
    sw = sw.reshape(-1, *sw.shape[2:])
    return sw[:, :prev_steps], sw[:, prev_steps]


def build_solver(epochs: int = 50, iters_per_epoch: int = 10, output_dir: Optional[str] = "./outputs_ns_cvit",
                 batch_size: int = 8, num_query_points: int = 256, learning_rate: float = 1e-3, prev_steps: int = 4,
                 n_traj: int = 8, data_path: Optional[str] = None, emb_dim: int = 96, depth: int = 3,
                 num_heads: int = 4, *, device: DeviceLike = None, seed: int = 42, log_freq: int = 10) -> Solver:
    device = resolve_device(device)
    np.random.seed(seed)
    random.seed(seed)
    inputs, labels = load_data(data_path, prev_steps, n_traj)
    B, T, H, W, C = inputs.shape
    labels = labels.reshape(B, H * W, C)
    xs = np.linspace(0, 1, H, dtype="float32")
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel()], -1)
    n_train = int(0.8 * B)
    rng = np.random.default_rng(0)

    def gen_input_batch():
        bi = rng.integers(0, n_train, batch_size)
        qi = np.sort(rng.choice(H * W, num_query_points, replace=False))
        return {"u": inputs[bi], "y": coords[qi][None].repeat(batch_size, 0), "batch_idx": bi, "query_idx": qi}

    def gen_label_batch(input_batch):
        bi = input_batch.pop("batch_idx")
        qi = input_batch.pop("query_idx")
        return {"s": labels[bi][:, qi]}

    sup = SupervisedConstraint({"dataset": {"name": "ContinuousNamedArrayDataset", "input": gen_input_batch,
                                            "label": gen_label_batch}},
                               MSELoss("mean"), {"s": lambda out: out["s"]}, name="Sup")
    model = CVit(input_keys=("u", "y"), output_keys=("s",), in_dim=C, coords_dim=2, spatial_dims=(T, H, W),
                 grid_size=(H, W), latent_dim=emb_dim, emb_dim=emb_dim, patch_size=(1, 4, 4), depth=depth,
                 num_heads=num_heads, dec_emb_dim=emb_dim, dec_num_heads=num_heads, dec_depth=1, num_mlp_layers=1,
                 mlp_ratio=1, out_dim=C, embedding_type="grid", generator=torch.Generator().manual_seed(seed),
                 device=device)
    n_test = B - n_train
    validator = {
        "ns_valid": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset",
                         "input": {"u": inputs[n_train:],
                                   "y": np.broadcast_to(coords[None], (n_test, H * W, 2)).copy()},
                         "label": {"s": labels[n_train:]}},
             "batch_size": min(16, n_test), "sampler": {"shuffle": False, "drop_last": False}},
            MSELoss("mean"), metric={"L2Rel": L2Rel()}, name="ns_valid")
    }
    return Solver(model, {"Sup": sup}, output_dir, AdamW(learning_rate, weight_decay=1e-5)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=False, validator=validator, log_freq=log_freq,
                  seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final L2Rel = {solver.eval()[0]:.4e}")
