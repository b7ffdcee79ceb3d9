"""Spherical FNO on the rotating shallow-water equations, on the port
(counterpart of ``examples/sfno_swe.py``).

``SFNONet`` (8 x 8 spherical modes, hidden 32, 3 -> 3 channels, 2
layers, equiangular grid) learns one step of the shallow-water operator on
a 16 x 32 grid from ``SphericalSWEDataset``'s synthetic pairs (the JAX
package's: band-limited fields advanced by a latitude-dependent rotation;
16 samples in batches of 4, shuffled); ``L2RelLoss``; Adam on a cosine
schedule at 2e-3, 4 steps an epoch; the score ``L2Rel``.

Run on the GPU: ``python -m paddlescience_torch.examples.sfno_swe [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.sfnonet import SFNONet
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import L2RelLoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["H", "W", "build_solver"]

H, W = 16, 32


def build_solver(epochs: int = 4, output_dir: Optional[str] = "./output_sfno_swe", *, shuffle: bool = True,
                 device: DeviceLike = None, seed: int = 0, log_freq: int = 4) -> Solver:
    device = resolve_device(device)
    np.random.seed(seed)
    random.seed(seed)
    model = SFNONet(("input",), ("output",), n_modes=(8, 8), hidden_channels=32, in_channels=3, out_channels=3,
                    n_layers=2, img_size=(H, W), generator=torch.Generator().manual_seed(seed), device=device)
    dl = {"dataset": {"name": "SphericalSWEDataset", "input_keys": ("input",), "label_keys": ("output",),
                      "num_samples": 16, "H": H, "W": W},
          "batch_size": 4, "sampler": {"shuffle": shuffle, "drop_last": True}}
    sup = SupervisedConstraint(dl, L2RelLoss(), {"output": lambda out: out["output"]}, name="Sup")
    validator = SupervisedValidator(dict(dl, sampler={"shuffle": False, "drop_last": False}), L2RelLoss(),
                                    metric={"L2Rel": L2Rel()}, name="swe_valid")
    lr = Cosine(epochs=epochs, iters_per_epoch=4, learning_rate=2e-3)()
    return Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=4,
                  validator={"swe_valid": validator}, eval_during_train=False, log_freq=log_freq, seed=seed,
                  device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 4)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final L2Rel = {solver.eval()[0]:.4e}")
