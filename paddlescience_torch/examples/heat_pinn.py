"""2-D steady heat conduction on the port (counterpart of
``examples/heat_pinn.py``).

Laplace(u) = 0 on [-1, 1]^2 with Dirichlet walls T = 75 (left), 0 (right),
50 (bottom), 0 (top), normalised by 75. An MLP 9 x 20 (tanh); the residual
on 99^2 evenly spaced interior points, each wall on 25 points (weight
0.25), MSE "mean"; Adam 5e-4; 50 epochs of 20 steps. :func:`evaluate_vs_fdm`
scores the network against a 5-point finite-difference solution (Jacobi
iterations in numpy, the JAX example's oracle) on a 100 x 100 grid.

Run on the GPU: ``python -m paddlescience_torch.examples.heat_pinn [epochs]``.
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
from paddlescience_torch.equation.pde.basic import Laplace
from paddlescience_torch.geometry import Rectangle
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "fdm_solve", "evaluate_vs_fdm"]

SEED = 42
NPOINT_PDE, NPOINT_BC = 99**2, 25


def fdm_solve(n: int, iters: int = 30000) -> np.ndarray:
    """The 5-point Laplace stencil with the Dirichlet walls, Jacobi-iterated
    (rows: y from -1, columns: x from -1)."""
    T = np.zeros((n + 2, n + 2), np.float64)
    T[0, :] = 50.0
    T[-1, :] = 0.0
    T[:, 0] = 75.0
    T[:, -1] = 0.0
    for _ in range(iters):
        T[1:-1, 1:-1] = 0.25 * (T[:-2, 1:-1] + T[2:, 1:-1] + T[1:-1, :-2] + T[1:-1, 2:])
    return T[1:-1, 1:-1]


def build_solver(epochs: int = 50, iters_per_epoch: int = 20, output_dir: Optional[str] = "./outputs_heat_pinn",
                 learning_rate: float = 5e-4, w_top: float = 0.25, w_bottom: float = 0.25, w_left: float = 0.25,
                 w_right: float = 0.25, *, npoint_pde: int = NPOINT_PDE, width: int = 20, num_layers: int = 9,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The heat solver of the JAX example (its weights from a
    ``torch.Generator`` seeded 42); ``npoint_pde``, ``width`` and
    ``num_layers`` cut it for tests; ``deriv`` names a derivative-path
    candidate to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x", "y"), ("u",), num_layers, width, activation="tanh",
                generator=torch.Generator().manual_seed(SEED), device=device)
    equation = {"heat": Laplace(dim=2)}
    rect = Rectangle((-1.0, -1.0), (1.0, 1.0))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    pde = InteriorConstraint(equation["heat"].equations, {"laplace": 0}, rect, {**cfg, "batch_size": npoint_pde},
                             MSELoss("mean"), evenly=True, name="EQ")

    def bc(name, value, criteria, weight):
        return BoundaryConstraint({"u": lambda out: out["u"]}, {"u": value}, rect, {**cfg, "batch_size": NPOINT_BC},
                                  MSELoss("mean"), weight_dict={"u": weight}, criteria=criteria, name=name)

    constraint = {
        "EQ": pde,
        "BC_top": bc("BC_top", 0.0, lambda x, y: np.isclose(y, 1), w_top),
        "BC_bottom": bc("BC_bottom", 50 / 75, lambda x, y: np.isclose(y, -1), w_bottom),
        "BC_left": bc("BC_left", 1.0, lambda x, y: np.isclose(x, -1), w_left),
        "BC_right": bc("BC_right", 0.0, lambda x, y: np.isclose(x, 1), w_right),
    }
    return Solver(model, constraint, output_dir, Adam(learning_rate)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=False, equation=equation, seed=SEED,
                  device=device)


def evaluate_vs_fdm(solver: Solver, n_eval: int = 100, fdm: Optional[np.ndarray] = None) -> float:
    """The mean squared difference between the network and the finite-
    difference field (divided by 75) on an n_eval^2 grid (the JAX example's
    report); ``fdm`` passes a field already solved by :func:`fdm_solve`."""
    xs = np.linspace(-1, 1, n_eval, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    pinn = solver.predict({"x": gx.reshape(-1, 1), "y": gy.reshape(-1, 1)}, batch_size=n_eval * n_eval,
                          return_numpy=True)["u"].reshape(n_eval, n_eval)
    fdm = (fdm_solve(n_eval) if fdm is None else fdm).T
    return float(np.mean(np.square(pinn - fdm / 75.0)))


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50)
    solver.train()
    print(f"The norm MSE loss between the FDM and PINN is {evaluate_vs_fdm(solver):.6e}")
