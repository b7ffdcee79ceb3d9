"""DeepCFD: a UNetEx surrogate of steady channel flow around obstacles, on
the port (counterpart of ``examples/deepcfd_unetex.py``; reference
``examples/deepcfd/deepcfd.py``).

``UNetEx`` (filters 8/16/32, 2 convolutions a block, one decoder per
output) maps (obstacle SDF, flow-region mask, wall SDF) images to (u, v,
p) on a 32 x 32 grid; the data are the JAX example's 32 synthetic
potential-flow-like samples around random circles (:func:`make_data`, the
same numpy draws). MSE, Adam at 1e-3, batches of 8 (shuffled, the short
last dropped), 4 steps an epoch; the score the validator's MSE.

Run on the GPU: ``python -m paddlescience_torch.examples.deepcfd_unetex
[epochs]``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.unetex import UNetEx
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["H", "W", "make_data", "build_solver"]

H = W = 32


def make_data(n=32, seed=0):
    """(n, 3, H, W) inputs (obstacle SDF, mask, wall SDF) and (n, 3, H, W)
    fields (u, v, p) around one random circle each."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / H
    x_in = np.zeros((n, 3, H, W), np.float32)
    y_out = np.zeros((n, 3, H, W), np.float32)
    for i in range(n):
        cx, cy, r = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), rng.uniform(0.08, 0.18)
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) - r
        mask = (d > 0).astype(np.float32)
        x_in[i, 0] = d
        x_in[i, 1] = mask
        x_in[i, 2] = np.minimum(yy, 1 - yy)
        scale = np.clip(d, 0, None) / (np.abs(d) + r)
        r2 = np.maximum(((xx - cx) ** 2 + (yy - cy) ** 2), 1e-4) ** 2
        y_out[i, 0] = mask * (1.0 - (r ** 2) * ((xx - cx) ** 2 - (yy - cy) ** 2) / r2)
        y_out[i, 1] = -mask * (r ** 2) * 2 * (xx - cx) * (yy - cy) / r2
        y_out[i, 2] = mask * scale
    return x_in, y_out


def build_solver(epochs: int = 4, output_dir: Optional[str] = "./output_deepcfd", *,
                 device: DeviceLike = None) -> Solver:
    """The JAX example's solver."""
    device = resolve_device(device)
    np.random.seed(0)
    x, y = make_data()
    model = UNetEx("input", "output", in_channel=3, out_channel=3, filters=(8, 16, 32), layers=2,
                   generator=torch.Generator().manual_seed(0), device=device)
    dl = {"dataset": {"name": "NamedArrayDataset", "input": {"input": x}, "label": {"output": y}},
          "batch_size": 8, "sampler": {"shuffle": True, "drop_last": True}}
    sup = SupervisedConstraint(dl, MSELoss("mean"), {"output": lambda out: out["output"]}, name="Sup")
    validator = SupervisedValidator({**dl, "sampler": {"shuffle": False, "drop_last": False}}, MSELoss("mean"),
                                    metric={"MSE": MSE()}, name="cfd_valid")
    return Solver(model, {"Sup": sup}, output_dir, Adam(1e-3)(model), epochs=epochs, iters_per_epoch=4,
                  validator={"cfd_valid": validator}, eval_during_train=False, log_freq=4, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 4)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final MSE = {solver.eval()[0]:.4e}")
