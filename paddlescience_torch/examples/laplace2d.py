"""Laplace 2-D PINN on the port (counterpart of ``examples/laplace2d.py``):

  u_xx + u_yy = 0 in (0, 1)^2,  u = cos(x) cosh(y) on the boundary,

whose solution is cos(x) cosh(y) everywhere.

MLP 5 x 20 (tanh); the ``Laplace(dim=2)`` residual on 99^2 + 400 evenly
spaced interior points and u on 400 boundary points, both fed whole every
step (MSE "sum"); Adam at 1e-3. The validator holds u against the
analytic solution on the same 10,201 evenly spaced points (MSE metric). No
derivative path is pinned unless ``deriv`` names one: widths of 20 are
under the lane gate, so the process default runs the plain jet path.

Run on the GPU: ``python -m paddlescience_torch.examples.laplace2d [epochs]``.
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
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "u_solution_func", "NPOINT_INTERIOR", "NPOINT_BC"]

NPOINT_INTERIOR = 99**2
NPOINT_BC = 400


def u_solution_func(out):
    return np.cos(out["x"]) * np.cosh(out["y"])


def build_solver(epochs: int = 20, iters_per_epoch: int = 1, output_dir: Optional[str] = "./output_laplace2d",
                 *, deriv: Optional[str] = None, device: DeviceLike = None, seed: int = 42,
                 log_freq: int = 10) -> Solver:
    """The laplace2d solver of the JAX example (host sampling seeded with
    ``seed`` as the example seeds it, the model's weights from a
    ``torch.Generator`` seeded with it); ``deriv`` names a derivative-path
    candidate to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(seed)
    random.seed(seed)
    model = MLP(("x", "y"), ("u",), 5, 20, generator=torch.Generator().manual_seed(seed), device=device)
    equation = {"laplace": Laplace(dim=2)}
    rect = Rectangle((0.0, 0.0), (1.0, 1.0))
    total = NPOINT_INTERIOR + NPOINT_BC
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    pde = InteriorConstraint(equation["laplace"].equations, {"laplace": 0}, rect, {**cfg, "batch_size": total},
                             MSELoss("sum"), evenly=True, name="EQ")
    bc = BoundaryConstraint({"u": lambda out: out["u"]}, {"u": u_solution_func}, rect,
                            {**cfg, "batch_size": NPOINT_BC}, MSELoss("sum"), name="BC")
    validator = {
        "MSE_Metric": GeometryValidator({"u": lambda out: out["u"]}, {"u": u_solution_func}, rect,
                                        {"dataset": "IterableNamedArrayDataset", "total_size": total}, MSELoss(),
                                        evenly=True, metric={"MSE": MSE()}, name="MSE_Metric")
    }
    return Solver(model, {c.name: c for c in (pde, bc)}, output_dir, Adam(1e-3)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=False, validator=validator, equation=equation,
                  log_freq=log_freq, seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 20)
    solver.train()
    print(f"final MSE.u = {solver.eval()[0]:.4e}")
