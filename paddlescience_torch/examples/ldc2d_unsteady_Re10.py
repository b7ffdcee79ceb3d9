"""Unsteady lid-driven cavity at Re = 10 on the port (counterpart of
``examples/ldc2d_unsteady_Re10.py``).

Time-dependent 2-D Navier-Stokes (nu 0.01, rho 1) on [0, 1.5] x [-0.05,
0.05]^2 at 16 time stamps: the residuals on 99^2 evenly spaced points at
each of the 15 stamps after t0 (weight 1e-4), the four walls (the lid
moves, u = 1), the initial state on 99^2 evenly spaced points at t0, MSE
"sum"; an MLP 9 x 50 (tanh; the kernels would pad it to 52); Adam under a
cosine schedule from 1e-3 with a 5% warmup; 20000 epochs of 1 step. The
validator reports the interior residuals' MSE on 99^2 x 16 evenly spaced
points (with t0), in batches of 8192. No derivative path is pinned unless
``deriv`` names one.

Run on the GPU: ``python -m paddlescience_torch.examples.ldc2d_unsteady_Re10 [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InitialConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import NavierStokes
from paddlescience_torch.geometry import Rectangle
from paddlescience_torch.geometry.timedomain import TimeDomain, TimeXGeometry
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "residual_mse"]

SEED = 42


def build_solver(epochs: int = 20000, iters_per_epoch: int = 1, output_dir: Optional[str] = "./output_ldc2d_unsteady",
                 nu: float = 0.01, rho: float = 1.0, ntime_all: int = 16, npoint_pde: int = 99**2,
                 eval_batch: int = 8192, residual_weight: float = 1e-4, *, width: int = 50, num_layers: int = 9,
                 deriv: Optional[str] = None, device: DeviceLike = None, log_freq: int = 100) -> Solver:
    """The unsteady cavity solver of the JAX example (host sampling seeded
    as there, the network's weights from a ``torch.Generator`` seeded 42);
    ``npoint_pde``, ``ntime_all``, ``width`` and ``num_layers`` cut it for
    tests; ``deriv`` names a derivative-path candidate to pin (None: none
    is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("t", "x", "y"), ("u", "v", "p"), num_layers, width, generator=torch.Generator().manual_seed(SEED),
                device=device)
    equation = {"NavierStokes": NavierStokes(nu, rho, 2, True)}
    timestamps = np.linspace(0.0, 1.5, ntime_all, endpoint=True).astype(np.float32)
    time_rect = TimeXGeometry(TimeDomain(0.0, 1.5, timestamps=timestamps), Rectangle((-0.05, -0.05), (0.05, 0.05)))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    ntime = ntime_all - 1
    n_side = int(round(np.sqrt(npoint_pde))) + 2
    residuals = ("continuity", "momentum_x", "momentum_y")
    pde = InteriorConstraint(equation["NavierStokes"].equations, {k: 0 for k in residuals}, time_rect,
                             {**cfg, "batch_size": npoint_pde * ntime}, MSELoss("sum"), evenly=True,
                             weight_dict={k: residual_weight for k in residuals}, name="EQ")
    walls = {
        "BC_top": ({"u": 1.0, "v": 0.0}, lambda t, x, y: np.isclose(y, 0.05), n_side * ntime),
        "BC_down": ({"u": 0.0, "v": 0.0}, lambda t, x, y: np.isclose(y, -0.05), n_side * ntime),
        "BC_left": ({"u": 0.0, "v": 0.0}, lambda t, x, y: np.isclose(x, -0.05), (n_side - 2) * ntime),
        "BC_right": ({"u": 0.0, "v": 0.0}, lambda t, x, y: np.isclose(x, 0.05), (n_side - 2) * ntime),
    }
    constraint = {"EQ": pde}
    for name, (label, crit, bs) in walls.items():
        constraint[name] = BoundaryConstraint({"u": lambda out: out["u"], "v": lambda out: out["v"]}, label,
                                              time_rect, {**cfg, "batch_size": bs}, MSELoss("sum"), criteria=crit,
                                              name=name)
    constraint["IC"] = InitialConstraint({"u": lambda out: out["u"], "v": lambda out: out["v"]},
                                         {"u": 0.0, "v": 0.0}, time_rect, {**cfg, "batch_size": npoint_pde},
                                         MSELoss("sum"), evenly=True, name="IC")
    lr = Cosine(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3,
                warmup_epoch=max(int(0.05 * epochs), 1))()
    validator = {
        "residual": GeometryValidator(equation["NavierStokes"].equations, {k: 0 for k in residuals}, time_rect,
                                      {"dataset": "NamedArrayDataset", "total_size": npoint_pde * ntime_all,
                                       "batch_size": eval_batch}, MSELoss("sum"), evenly=True,
                                      metric={"MSE": MSE()}, with_initial=True, name="residual")
    }
    return Solver(model, constraint, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  validator=validator, equation=equation, log_freq=log_freq, seed=SEED, device=device)


def residual_mse(solver: Solver) -> dict:
    """The validator's MSE of each interior residual (the JAX example's
    evaluation)."""
    return solver.eval()[1]["residual"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 20000)
    solver.train()
    print(f"residual MSE: {residual_mse(solver)}")
