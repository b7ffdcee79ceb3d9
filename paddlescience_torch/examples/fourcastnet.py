"""FourCastNet: AFNO autoregressive weather prediction, on the port
(counterpart of ``examples/fourcastnet.py``; the finetune stage is
``fourcastnet_finetune.py``).

``AFNONet`` on 32 x 64 fields of 4 channels (patch 4, embed 64, depth 4,
4 blocks) learns frame t -> frame t + 1 (``num_timestamps`` > 1: rolls out
that many steps, each supervised by its frame). The fields are the JAX
example's synthetic ERA5 stand-in, smooth band-limited spectra advected
eastward one cell a frame (:func:`make_synthetic_era5`, the same numpy
draw), built in memory and windowed by ``ERA5Dataset`` (its ``data``
argument), so no HDF5 file and no h5py are needed; an existing
``data_path`` file is read instead (with h5py). Windows 32 of them,
batches of 4 (shuffled, the short last dropped), 8 steps an epoch;
``L2RelLoss``; Adam on a cosine schedule at 5e-4 with one warmup epoch;
the scores ``RMSE`` and ``LatitudeWeightedACC``.

Run on the GPU: ``python -m paddlescience_torch.examples.fourcastnet
[epochs]``.
"""

from __future__ import annotations

import os
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.afno import AFNONet
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import L2RelLoss
from paddlescience_torch.metric import RMSE, LatitudeWeightedACC
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["IMG_H", "IMG_W", "CHANNELS", "make_synthetic_era5", "build_solver"]

IMG_H, IMG_W, CHANNELS = 32, 64, 4


def make_synthetic_era5(T: int = 40) -> np.ndarray:
    """(T, C, H, W) float32 fields: smooth spectral fields rolled east one
    cell a frame, normalised to zero mean and unit deviation."""
    rng = np.random.default_rng(0)
    spec = rng.normal(size=(CHANNELS, IMG_H, IMG_W)) + 1j * rng.normal(size=(CHANNELS, IMG_H, IMG_W))
    ky = np.abs(np.fft.fftfreq(IMG_H, 1 / IMG_H))[:, None]
    kx = np.abs(np.fft.fftfreq(IMG_W, 1 / IMG_W))[None, :]
    spec *= ((kx**2 + ky**2) <= 16).astype(float)
    f = np.real(np.fft.ifft2(spec))
    data = np.stack([np.roll(f, shift=t, axis=-1) for t in range(T)]).astype(np.float32)
    return (data - data.mean()) / (data.std() + 1e-9)


def build_solver(epochs: int = 4, output_dir: Optional[str] = "./output_fourcastnet",
                 data_path: Optional[str] = None, num_timestamps: int = 1,
                 pretrained_model_path: Optional[str] = None, *, shuffle: bool = True, device: DeviceLike = None,
                 seed: int = 1024, log_freq: int = 8) -> Solver:
    """The JAX example's solver; ``num_timestamps`` > 1 is the finetune
    stage, warm-started from ``pretrained_model_path`` when given."""
    device = resolve_device(device)
    np.random.seed(seed)
    random.seed(seed)
    output_keys = tuple(f"output_{i}" for i in range(num_timestamps)) if num_timestamps > 1 else ("output",)
    model = AFNONet(("input",), output_keys, img_size=(IMG_H, IMG_W), patch_size=(4, 4), in_channels=CHANNELS,
                    out_channels=CHANNELS, embed_dim=64, depth=4, num_blocks=4, num_timestamps=num_timestamps,
                    generator=torch.Generator().manual_seed(seed), device=device)
    source = ({"file_path": data_path} if data_path and os.path.exists(data_path)
              else {"file_path": None, "data": make_synthetic_era5()})
    train_dl = {"dataset": {"name": "ERA5Dataset", **source, "input_keys": ("input",), "label_keys": output_keys,
                            "num_label_timestamps": num_timestamps, "size": 32},
                "batch_size": 4, "sampler": {"shuffle": shuffle, "drop_last": True}}
    expr = {k: (lambda kk: lambda out: out[kk])(k) for k in output_keys}
    sup = SupervisedConstraint(train_dl, L2RelLoss(), expr, name="Sup")
    eval_dl = dict(train_dl, sampler={"shuffle": False, "drop_last": False})
    validator = SupervisedValidator(eval_dl, L2RelLoss(), expr,
                                    metric={"RMSE": RMSE(), "ACC": LatitudeWeightedACC(num_lat=IMG_H)},
                                    name="era5_valid")
    lr = Cosine(epochs=epochs, iters_per_epoch=8, learning_rate=5e-4, warmup_epoch=1)()
    solver = Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=8,
                    validator={"era5_valid": validator}, eval_during_train=False, log_freq=log_freq, seed=seed,
                    device=device)
    if pretrained_model_path:
        solver.load_pretrain(pretrained_model_path)
    return solver


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 4)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final RMSE = {solver.eval()[0]:.4e}")
