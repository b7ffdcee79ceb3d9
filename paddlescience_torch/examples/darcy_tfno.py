"""Darcy flow operator learning with a TFNO or a UNO on the port
(counterpart of ``examples/darcy_tfno.py``).

Learns a -> u for -div(a grad u) = 1 on (0, 1)^2 from data made by the
finite-difference Darcy solver (``data/dataset/science_dataset.py``):
``n_train + n_eval`` samples at ``resolution``^2, the input field
normalised and given two grid channels (x and y on [0, 1]). The model is
``TFNO2dNet`` with 16 x 16 modes, 32 hidden channels, lifting 256,
projection 64 and 4 layers; the loss the per-sample relative H1 norm
(the function and its circular central differences) summed over the batch
(``FunctionalLoss``); AdamW at 5e-3 with weight decay 1e-4 on a ``Step``
schedule halving the rate every 60 epochs; shuffled batches of 16 (``n_train
// 16`` steps an epoch); evaluation every 10 epochs of the mean per-sample
relative L2 on the held-out samples. ``arch="uno"`` trains the JAX
example's UNO instead (``arch/unonet.py``: hidden 32, lifting and
projection 64, four stages of (32, 64, 64, 32) channels with (12, 12),
(8, 8), (8, 8), (12, 12) modes, scaled by 1, 0.5, 2 and 1;
``examples/darcy_uno.py``).

Run on the GPU: ``python -m paddlescience_torch.examples.darcy_tfno
[epochs [arch]]`` (each epoch one CUDA graph of ``n_train // 16`` steps).
"""

from __future__ import annotations

import math
import random
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.fno import TFNO2dNet
from paddlescience_torch.arch.unonet import UNONet
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.data.dataset.science_dataset import generate_darcy_dataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss, L2RelLoss
from paddlescience_torch.metric import FunctionalMetric
from paddlescience_torch.optimizer.lr_scheduler import Step
from paddlescience_torch.optimizer.optimizer import AdamW
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "h1_rel_loss", "l2_rel_metric", "with_grid", "make_data"]


def _central_diff_2d(x, h):
    """Circular central differences on the last two axes."""
    dx = (torch.roll(x, -1, dims=-2) - torch.roll(x, 1, dims=-2)) / (2.0 * h[0])
    dy = (torch.roll(x, -1, dims=-1) - torch.roll(x, 1, dims=-1)) / (2.0 * h[1])
    return dx, dy


def h1_rel_loss(output_dict, label_dict, weight_dict=None):
    """The per-sample relative H1 norm (the function and its first
    differences on a uniform 2 pi / n grid), summed over the batch."""
    x, y = output_dict["output"], label_dict["output"]
    h = [2 * math.pi / x.shape[-2], 2 * math.pi / x.shape[-1]]
    x_x, x_y = _central_diff_2d(x, h)
    y_x, y_y = _central_diff_2d(y, h)

    def sq_norm(v):
        return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1) ** 2

    diff, ynorm = sq_norm(x - y), sq_norm(y)
    for xd, yd in ((x_x, y_x), (x_y, y_y)):
        diff = diff + sq_norm(xd - yd)
        ynorm = ynorm + sq_norm(yd)
    return {"output": torch.sum(torch.sqrt(diff) / torch.sqrt(ynorm))}


def l2_rel_metric(output_dict, label_dict):
    """The mean per-sample relative L2."""
    x = output_dict["output"].reshape(output_dict["output"].shape[0], -1)
    y = label_dict["output"].reshape(label_dict["output"].shape[0], -1)
    return {"l2": torch.mean(torch.linalg.vector_norm(x - y, dim=-1) / torch.linalg.vector_norm(y, dim=-1))}


def with_grid(a: np.ndarray) -> np.ndarray:
    """(N, 1, R, R) -> (N, 3, R, R): the x and y grids on [0, 1] as channels."""
    n, _, rx, ry = a.shape
    gx, gy = np.meshgrid(np.linspace(0, 1, rx), np.linspace(0, 1, ry), indexing="ij")
    grid = np.broadcast_to(np.stack([gx, gy]).astype(a.dtype)[None], (n, 2, rx, ry))
    return np.concatenate([a, grid], axis=1)


def make_data(n_samples: int, resolution: int):
    """The example's inputs (normalised a with grid channels) and labels u."""
    a, u = generate_darcy_dataset(n_samples, resolution, seed=0)
    return with_grid((a - a.mean()) / a.std()), u


def build_solver(epochs: int = 300, n_train: int = 1000, n_eval: int = 100, resolution: int = 16,
                 output_dir: Optional[str] = "./output_darcy_tfno", arch: str = "tfno", batch_size: int = 16, *,
                 data: Optional[Tuple[np.ndarray, np.ndarray]] = None, shuffle: bool = True,
                 device: DeviceLike = None, seed: int = 42, log_freq: int = 50) -> Solver:
    """The Darcy solver of the JAX example (``arch`` "tfno" or "uno"), on ``data`` (the inputs
    and labels of :func:`make_data`) when given, else on data generated
    here. The model's weights come from a ``torch.Generator`` seeded with
    ``seed``, the loader's shuffled order from another (the JAX loader
    draws it with numpy, so the orders differ; ``shuffle=False`` walks the
    samples in order in both)."""
    if arch not in ("tfno", "uno"):
        raise ValueError(f"unknown arch '{arch}' (tfno, uno)")
    device = resolve_device(device)
    np.random.seed(seed)
    random.seed(seed)
    a, u = data if data is not None else make_data(n_train + n_eval, resolution)
    g = torch.Generator().manual_seed(seed)
    if arch == "uno":
        model = UNONet(("input",), ("output",), in_channels=3, out_channels=1, hidden_channels=32,
                       lifting_channels=64, projection_channels=64, n_layers=4, uno_out_channels=(32, 64, 64, 32),
                       uno_n_modes=((12, 12), (8, 8), (8, 8), (12, 12)),
                       uno_scalings=((1.0, 1.0), (0.5, 0.5), (2.0, 2.0), (1.0, 1.0)), generator=g, device=device)
    else:
        model = TFNO2dNet(("input",), ("output",), n_modes_height=16, n_modes_width=16, hidden_channels=32,
                          in_channels=3, out_channels=1, lifting_channels=256, projection_channels=64, n_layers=4,
                          generator=g, device=device)
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": {"input": a[:n_train]}, "label": {"output": u[:n_train]}},
         "batch_size": batch_size, "sampler": {"shuffle": shuffle}},
        FunctionalLoss(h1_rel_loss), {"output": lambda out: out["output"]}, name="Sup")
    validator = {
        "u_val": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": {"input": a[n_train:]},
                         "label": {"output": u[n_train:]}}, "batch_size": batch_size},
            L2RelLoss(), {"output": lambda out: out["output"]},
            metric={"l2": FunctionalMetric(l2_rel_metric)}, name="u_val")
    }
    iters = max(n_train // batch_size, 1)
    lr = Step(epochs=epochs, iters_per_epoch=iters, learning_rate=5e-3, step_size=60, gamma=0.5, by_epoch=True)()
    return Solver(model, {"Sup": sup}, output_dir, AdamW(lr, weight_decay=1e-4)(model), epochs=epochs,
                  iters_per_epoch=iters, validator=validator, eval_during_train=True, eval_freq=10,
                  log_freq=log_freq, seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 300, arch=argv[1] if len(argv) > 1 else "tfno")
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final l2 = {solver.eval()[0]:.4e}")
