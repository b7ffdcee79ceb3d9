"""Poiseuille channel flow on the port (counterpart of
``examples/poiseuille_flow.py``).

Steady 2-D Navier-Stokes (nu 0.05, rho 1) in the channel [0, 1] x
[-0.25, 0.25], driven by a pressure ramp p = G (L - x) on the inlet and
outlet (G 0.4), no-slip walls; the exact solution is the parabola
u(y) = G / (2 nu rho) (R^2 - y^2), v = 0. An MLP 4 x 64 (tanh) maps (x, y)
to (u, v, p); the residuals on 2048 x 50 interior points, the walls on 256
x 50, the pressure on 128 x 50 (each sampled once and fed whole every
step, as the JAX example's dataloader configuration does;
``sample_iters`` cuts it), MSE "mean"; Adam 1e-3; 40 epochs of 50 steps.
No derivative path is pinned unless ``deriv`` names one. :func:`l2rel`
scores u on the mid-channel profile against the parabola.

Run on the GPU: ``python -m paddlescience_torch.examples.poiseuille_flow [epochs]``.
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
from paddlescience_torch.equation.pde.basic import NavierStokes
from paddlescience_torch.geometry import Rectangle
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "u_exact", "l2rel"]

L_CH, R_CH, NU, RHO, G = 1.0, 0.25, 0.05, 1.0, 0.4  # dp/dx = -G
ITERS = 50
SEED = 42


def u_exact(y):
    return G / (2 * NU * RHO) * (R_CH**2 - y**2)


def build_solver(epochs: int = 40, output_dir: Optional[str] = "./output_poiseuille", *,
                 sample_iters: Optional[int] = None, batch_sizes=(2048, 256, 128), width: int = 64,
                 num_layers: int = 4, deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The Poiseuille solver of the JAX example (host sampling seeded as
    there, the network's weights from a ``torch.Generator`` seeded 42).
    ``sample_iters`` sets the iterations each constraint samples for (None:
    the example's 50); ``batch_sizes`` (interior, walls, inlet/outlet),
    ``width`` and ``num_layers`` cut it for tests; ``deriv`` names a
    derivative-path candidate to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x", "y"), ("u", "v", "p"), num_layers, width, generator=torch.Generator().manual_seed(SEED),
                device=device)
    equation = {"NavierStokes": NavierStokes(nu=NU, rho=RHO, dim=2, time=False)}
    geom = Rectangle((0.0, -R_CH), (L_CH, R_CH))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": ITERS if sample_iters is None else sample_iters}
    n_eq, n_wall, n_p = batch_sizes
    interior = InteriorConstraint(equation["NavierStokes"].equations,
                                  {k: 0 for k in ("continuity", "momentum_x", "momentum_y")}, geom,
                                  {**cfg, "batch_size": n_eq}, MSELoss("mean"), name="EQ")
    walls = BoundaryConstraint({"u": lambda out: out["u"], "v": lambda out: out["v"]}, {"u": 0, "v": 0}, geom,
                               {**cfg, "batch_size": n_wall}, MSELoss("mean"),
                               criteria=lambda x, y: np.isclose(np.abs(y), R_CH), name="WALL")
    pio = BoundaryConstraint({"p": lambda out: out["p"]}, {"p": lambda d: G * (L_CH - d["x"])}, geom,
                             {**cfg, "batch_size": n_p}, MSELoss("mean"),
                             criteria=lambda x, y: np.isclose(x, 0.0) | np.isclose(x, L_CH), name="PIO")
    return Solver(model, {"EQ": interior, "WALL": walls, "PIO": pio}, output_dir, Adam(1e-3)(model), epochs=epochs,
                  iters_per_epoch=ITERS, equation=equation, log_freq=500, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The relative L2 error of u on 64 points across the channel at x = L / 2
    against the parabola (the JAX example's report)."""
    y = np.linspace(-R_CH, R_CH, 64, dtype=np.float32).reshape(-1, 1)
    pred = solver.predict({"x": np.full_like(y, L_CH / 2), "y": y}, return_numpy=True)["u"]
    truth = u_exact(y)
    return float(np.linalg.norm(pred - truth) / np.linalg.norm(truth))


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 40)
    solver.train()
    print(f"Poiseuille u-profile L2Rel vs parabola: {l2rel(solver):.4f}")
