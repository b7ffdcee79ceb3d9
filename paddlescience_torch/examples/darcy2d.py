"""2-D Darcy flow PINN with a manufactured solution on the port
(counterpart of ``examples/darcy2d.py``).

-lap(p) = f with f = 8 pi^2 sin(2 pi x) cos(2 pi y) on the unit square, so
p = sin(2 pi x) cos(2 pi y), whose values are the Dirichlet data. An MLP
5 x 64 (tanh) behind 128 random Fourier features (scale 2); the residual
on 2048 x 25 interior points and the boundary on 512 x 25, sampled once
and fed whole every step, MSE "mean"; Adam under the one-cycle schedule
(max 1e-3, cosine) for 40 epochs of 25 steps. Labels are lambdas of the
sampled coordinates, as in the JAX example. :func:`l2rel` is the
validator's L2Rel of p on 4096 points.

Run on the GPU: ``python -m paddlescience_torch.examples.darcy2d [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import Poisson
from paddlescience_torch.geometry import Rectangle
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import OneCycleLR
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "p_exact", "l2rel"]

SEED = 42
ITERS = 25


def p_exact(x, y):
    return np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)


def build_solver(epochs: int = 40, output_dir: Optional[str] = "./output_darcy2d", *, bs_pde: int = 2048,
                 bs_bc: int = 512, sample_iters: int = ITERS, width: int = 64, num_layers: int = 5, fourier_dim: int = 128,
                 deriv: Optional[str] = None, device: DeviceLike = None, log_freq: int = 200) -> Solver:
    """The darcy2d solver of the JAX example (host sampling seeded 42, the
    weights from a ``torch.Generator`` seeded 42); the sizes (and
    ``sample_iters``, the iterations' worth of points sampled) cut it for
    tests; ``deriv`` names a derivative-path candidate to pin."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x", "y"), ("p",), num_layers, width, fourier={"dim": fourier_dim, "scale": 2.0},
                generator=torch.Generator().manual_seed(SEED), device=device)
    equation = {"Poisson": Poisson(2)}
    geom = Rectangle((0.0, 0.0), (1.0, 1.0))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": sample_iters}
    interior = InteriorConstraint(
        equation["Poisson"].equations,
        {"poisson": lambda d: -8.0 * np.pi**2 * np.sin(2 * np.pi * d["x"]) * np.cos(2 * np.pi * d["y"])},
        geom, {**cfg, "batch_size": bs_pde}, MSELoss("mean"), name="EQ")
    bc = BoundaryConstraint({"p": lambda out: out["p"]}, {"p": lambda d: p_exact(d["x"], d["y"])}, geom,
                            {**cfg, "batch_size": bs_bc}, MSELoss("mean"), name="BC")
    validator = GeometryValidator({"p": lambda out: out["p"]}, {"p": lambda d: p_exact(d["x"], d["y"])}, geom,
                                  {"dataset": "NamedArrayDataset", "total_size": 4096, "batch_size": 4096},
                                  MSELoss("mean"), metric={"L2Rel": L2Rel()}, name="L2Rel_Metric")
    lr = OneCycleLR(epochs=epochs, iters_per_epoch=ITERS, max_learning_rate=1e-3)()
    return Solver(model, {"EQ": interior, "BC": bc}, output_dir, Adam(lr)(model), epochs=epochs,
                  iters_per_epoch=ITERS, equation=equation, validator={"L2Rel_Metric": validator},
                  eval_during_train=False, log_freq=log_freq, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    return solver.eval()[1]["L2Rel_Metric"]["L2Rel.p"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 40)
    solver.train()
    print(f"darcy2d L2Rel of p: {l2rel(solver):.4f}")
