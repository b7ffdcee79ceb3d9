"""CViT on 1-D linear advection, on the port (counterpart of
``examples/adv_cvit.py``).

``CVit1D`` (patch 4, grid 200, latent 128, embed 128, depth 4, 4 heads,
MLP ratio 2) learns u0 -> u(T) of periodic linear advection on N_GRID =
200 points. The data are the JAX example's: the ``adv_a0.npy`` /
``adv_aT.npy`` arrays under ``data_dir`` when present, otherwise random
Fourier series and, as labels, their exact periodic shift by half the
period (:func:`synth_adv`, the same numpy draw). Training batches are
fresh every step (``ContinuousNamedArrayDataset``: 64 functions of the
first 80%, at 128 sorted random grid points, from one numpy generator);
the solver stages each into the device buffers its captured chunk reads.
MSE loss; AdamW (weight decay 1e-5) on an exponential decay of 0.9 every
tenth of the run; the score ``L2Rel`` on the held-out 20% at every grid
point.

Run on the GPU: ``python -m paddlescience_torch.examples.adv_cvit [epochs]``.
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.cvit import CVit1D
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import AdamW
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["N_GRID", "SHIFT", "synth_adv", "load_data", "build_solver"]

N_GRID = 200
SHIFT = 0.5  # c T in periodic units


def synth_adv(n, seed=0):
    """``n`` random Fourier series on the periodic grid and their exact
    advected solutions: (n, N_GRID) each, float32."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, N_GRID, endpoint=False)
    k = np.arange(1, 9)
    a = rng.standard_normal((n, k.size)) / k
    b = rng.standard_normal((n, k.size)) / k
    u0 = a @ np.sin(2 * np.pi * np.outer(k, x)) + b @ np.cos(2 * np.pi * np.outer(k, x))
    u0 = u0 / np.abs(u0).max(axis=1, keepdims=True)
    uT = np.roll(u0, int(SHIFT * N_GRID), axis=1)
    return u0.astype("float32"), uT.astype("float32")


def load_data(data_dir, n=4096, seed=0):
    a0p, aTp = osp.join(data_dir or ".", "adv_a0.npy"), osp.join(data_dir or ".", "adv_aT.npy")
    if data_dir and osp.exists(a0p) and osp.exists(aTp):
        return np.load(a0p).astype("float32").T, np.load(aTp).astype("float32").T
    print(f"[adv_cvit] {data_dir!r} data absent -> synthetic Fourier advection set")
    return synth_adv(n, seed)


def build_solver(epochs: int = 100, iters_per_epoch: int = 20, output_dir: Optional[str] = "./outputs_adv_cvit",
                 batch_size: int = 64, grid_size: int = 128, learning_rate: float = 1e-3, n_data: int = 4096,
                 data_dir: Optional[str] = "./dataset/adv", emb_dim: int = 128, depth: int = 4, num_heads: int = 4, *,
                 device: DeviceLike = None, seed: int = 42, log_freq: int = 20) -> Solver:
    device = resolve_device(device)
    np.random.seed(seed)
    random.seed(seed)
    u0, uT = load_data(data_dir, n_data)
    grid = np.linspace(0, 1, N_GRID, dtype="float32")
    n_train = int(0.8 * len(u0))
    tr_u, tr_s = u0[:n_train, :, None], uT[:n_train]
    te_u, te_s = u0[n_train:, :, None], uT[n_train:]
    rng = np.random.default_rng(0)

    def gen_input_batch():
        batch_idx = rng.integers(0, tr_u.shape[0], batch_size)
        grid_idx = np.sort(rng.integers(0, N_GRID, grid_size))
        return {"u": tr_u[batch_idx], "y": grid[grid_idx][None, :, None].repeat(batch_size, 0),
                "batch_idx": batch_idx, "grid_idx": grid_idx}

    def gen_label_batch(input_batch):
        batch_idx = input_batch.pop("batch_idx")
        grid_idx = input_batch.pop("grid_idx")
        return {"s": tr_s[batch_idx][:, grid_idx, None]}

    sup = SupervisedConstraint({"dataset": {"name": "ContinuousNamedArrayDataset", "input": gen_input_batch,
                                            "label": gen_label_batch}},
                               MSELoss("mean"), {"s": lambda out: out["s"]}, name="Sup")
    model = CVit1D(input_keys=("u", "y"), output_keys=("s",), spatial_dims=N_GRID, in_dim=1, coords_dim=1,
                   patch_size=(4,), grid_size=(N_GRID,), latent_dim=128, emb_dim=emb_dim, depth=depth,
                   num_heads=num_heads, dec_emb_dim=emb_dim, dec_num_heads=num_heads, dec_depth=1, num_mlp_layers=1,
                   mlp_ratio=2, out_dim=1, generator=torch.Generator().manual_seed(seed), device=device)
    n_test = len(te_u)
    validator = {
        "adv_valid": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset",
                         "input": {"u": te_u, "y": np.broadcast_to(grid[None, :, None], (n_test, N_GRID, 1)).copy()},
                         "label": {"s": te_s[..., None]}},
             "batch_size": min(256, n_test), "sampler": {"shuffle": False, "drop_last": False}},
            MSELoss("mean"), metric={"L2Rel": L2Rel()}, name="adv_valid")
    }
    lr = ExponentialDecay(epochs, iters_per_epoch, learning_rate, gamma=0.9,
                          decay_steps=max(epochs // 10, 1) * iters_per_epoch)()
    return Solver(model, {"Sup": sup}, output_dir, AdamW(lr, weight_decay=1e-5)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=False, validator=validator, log_freq=log_freq,
                  seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 100)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final L2Rel = {solver.eval()[0]:.4e}")
