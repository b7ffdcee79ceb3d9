"""NowcastNet precipitation nowcasting on the port (counterpart of
``examples/nowcastnet_radar.py``).

NowcastNet (``arch/nowcasting.py``: the evolution network advecting the
last frame by its predicted motion plus an intensity residual, then the
SPADE generative network) at 32 x 32, 4 input frames of 10, ngf 16, trained
briefly with MSE through the ``Solver`` on ``RadarDataset``'s advecting
rain cells (batches of 4, shuffled, the short last dropped; 4 steps an
epoch, graphed chunks on CUDA); Adam 1e-3. :func:`_report` predicts the
first window and writes its frame strip with ``VisualizerRadar`` (which
needs matplotlib).

Run on the GPU: ``python -m paddlescience_torch.examples.nowcastnet_radar
[epochs]``.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.nowcasting import NowcastNet
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.data import build_dataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.visualize import VisualizerRadar

__all__ = ["H", "W", "IN_LEN", "TOTAL", "build_solver", "_report"]

H = W = 32
IN_LEN, TOTAL = 4, 10
SEED = 0  # the JAX example's set_random_seed


def build_solver(epochs: int = 3, output_dir: Optional[str] = "./output_nowcastnet", *, device: DeviceLike = None,
                 height: int = H, width: int = W, input_length: int = IN_LEN, total_length: int = TOTAL,
                 ngf: int = 16, batch_size: int = 4, iters_per_epoch: int = 4, num_cases: int = 8) -> Solver:
    """The JAX example's solver; the keywords after ``device`` default to
    its configuration (the card's smoke run widens them)."""
    device = resolve_device(device)
    model = NowcastNet(("input",), ("output",), input_length=input_length, total_length=total_length,
                       image_height=height, image_width=width, ngf=ngf,
                       generator=torch.Generator().manual_seed(SEED), device=device)
    dl = {"dataset": {"name": "RadarDataset", "input_keys": ("input",), "label_keys": ("output",),
                      "image_width": width, "image_height": height, "total_length": total_length,
                      "input_length": input_length, "num_cases": num_cases},
          "batch_size": batch_size, "sampler": {"name": "BatchSampler", "shuffle": True, "drop_last": True}}
    sup = SupervisedConstraint(dl, MSELoss("mean"), {"output": lambda out: out["output"]}, name="Sup")
    return Solver(model, {"Sup": sup}, output_dir, Adam(1e-3)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  log_freq=iters_per_epoch, device=device)


def _report(solver: Solver) -> float:
    """Predict the first radar window, write its strip (``nowcast_pred.png``
    under the solver's output directory) and return the mean |prediction|."""
    ds = build_dataset({"name": "RadarDataset", "input_keys": ("input",), "label_keys": ("output",),
                        "image_width": W, "image_height": H, "total_length": TOTAL, "input_length": IN_LEN})
    x = ds.input["input"][:1]
    pred = solver.predict({"input": x}, return_numpy=True)["output"]
    vis = VisualizerRadar({"input": x}, {"pred": lambda d: d["pred"]})
    vis.save(os.path.join(solver.output_dir or ".", "nowcast"), {"pred": pred[0, :, :, :, 0]})
    print(f"nowcastnet: predicted {pred.shape[1]} frames, strip saved")
    return float(np.abs(pred).mean())


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 3)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    _report(solver)
