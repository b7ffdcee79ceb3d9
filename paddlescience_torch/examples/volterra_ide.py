"""Volterra integro-differential equation on the port (counterpart of
``examples/volterra_ide.py``).

u'(x) + u(x) = int_0^x e^(t - x) u(t) dt on [0, 5] with u(0) = 1, whose
solution is e^(-x) cosh(x). An MLP 3 x 20 (tanh) maps x to u. The residual
u' + u - integral on 12 collocation points, the integral by 20-point
Gauss-Legendre quadrature: ``Volterra.precompute`` builds the (12, 252)
matrix on the solver's device once and returns the 12 + 240 points the
network runs on every step; the initial condition u(0) = 1; MSE "mean";
Adam 1e-3; 50 epochs of 20 steps. The validator reports the L2Rel of u on
100 evenly spaced points.

Run on the GPU: ``python -m paddlescience_torch.examples.volterra_ide [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import ad
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.ide.volterra import Volterra
from paddlescience_torch.geometry.geometry_1d import Interval
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "u_exact", "l2rel"]

SEED = 42
BOUND, NUM_POINTS, QUAD_DEG, T1 = 0.0, 12, 20, 5.0


def u_exact(out):
    x = out["x"]
    return np.exp(-x) * np.cosh(x)


def build_solver(epochs: int = 50, iters_per_epoch: int = 20, output_dir: Optional[str] = "./output_volterra", *,
                 width: int = 20, num_layers: int = 3, deriv: Optional[str] = None,
                 device: DeviceLike = None) -> Solver:
    """The Volterra solver of the JAX example (the network's weights from a
    ``torch.Generator`` seeded 42, the quadrature matrix on ``device``);
    ``width`` and ``num_layers`` cut it for tests; ``deriv`` names a
    derivative-path candidate to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x",), ("u",), num_layers, width, generator=torch.Generator().manual_seed(SEED), device=device)
    eq = Volterra(BOUND, NUM_POINTS, QUAD_DEG, lambda t, s: np.exp(s - t),
                  lambda out: ad.jacobian(out["u"], out["x"]) + out["u"])
    x_col = np.linspace(0, T1, NUM_POINTS, dtype=np.float32)
    full_x = eq.precompute(x_col, device=device)
    sup = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"x": full_x},
                     "label": {"volterra": np.zeros((NUM_POINTS, 1), np.float32)}}},
        MSELoss("mean"), {"volterra": eq.equations["volterra"]}, name="EQ")
    ic = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"x": np.zeros((1, 1), np.float32)},
                     "label": {"u": np.ones((1, 1), np.float32)}}},
        MSELoss("mean"), {"u": lambda out: out["u"]}, name="IC")
    validator = {
        "u_val": GeometryValidator({"u": lambda out: out["u"]}, {"u": u_exact}, Interval(0, T1),
                                   {"dataset": "IterableNamedArrayDataset", "total_size": 100}, MSELoss(),
                                   evenly=True, metric={"L2Rel": L2Rel()}, name="u_val")
    }
    return Solver(model, {"EQ": sup, "IC": ic}, output_dir, Adam(1e-3)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, validator=validator, log_freq=200, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The validator's L2Rel of u against e^(-x) cosh(x)."""
    return solver.eval()[1]["u_val"]["L2Rel.u"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50)
    solver.train()
    print(f"Volterra L2Rel of u: {l2rel(solver):.4f}")
