"""Lid-driven cavity, steady Navier-Stokes PINN on the port (counterpart
of ``examples/ldc2d_steady.py``).

MLP 4 x 50 (tanh) maps (x, y) to (u, v, p) in the square (-0.05, 0.05)^2;
``NavierStokes(1 / re, 1, 2, False)`` residuals on 2048 x
``iters_per_epoch`` evenly spaced interior points (MSE "sum", weight 1e-4
each); the lid (y = 0.05, u = 1, v = 0) on 256 x ``iters_per_epoch``
boundary points and the other walls (u = v = 0) on 768 x
``iters_per_epoch``, all fed whole every step, as the JAX example samples
them (153,600 points a step at the defaults); Adam on a Cosine schedule from 1e-3 with
max(epochs // 20, 1) warm-up epochs. The validator holds the three
residuals against 0 on 2048 interior points (MSE metric, "sum" loss).
``lbfgs=True`` is the JAX example's L-BFGS branch: ``LBFGS(max_iter=10)``
(optax's L-BFGS, at most 10 line-search trials a step) in place of Adam,
``train()`` then running its steps one by one. "Adam+L-BFGS" is two
solvers: train one with Adam, build a second with ``lbfgs=True``, copy the
first's parameters into it (``load_pretrain`` of its checkpoint, or
``_load_state({"params": ...}, params_only=True)``) and train on. No
derivative path is pinned unless
``deriv`` names one: widths of 50 are under the lane gate, so the process
default runs the plain jet path.

Run on the GPU: ``python -m paddlescience_torch.examples.ldc2d_steady
[epochs] [iters_per_epoch] [lbfgs]``.
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
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import LBFGS, Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver"]


def build_solver(epochs: int = 50, iters_per_epoch: int = 50, re: float = 10.0,
                 output_dir: Optional[str] = "./output_ldc2d", lbfgs: bool = False, *,
                 deriv: Optional[str] = None, device: DeviceLike = None, seed: int = 42,
                 log_freq: int = 100) -> Solver:
    """The ldc2d_steady solver of the JAX example with Adam, or with L-BFGS
    when ``lbfgs`` (host sampling seeded with ``seed`` as the example seeds
    it); ``deriv`` names a derivative-path candidate to pin (None: none is
    pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(seed)
    random.seed(seed)
    model = MLP(("x", "y"), ("u", "v", "p"), 4, 50, generator=torch.Generator().manual_seed(seed), device=device)
    equation = {"NavierStokes": NavierStokes(1.0 / re, 1.0, 2, False)}
    rect = Rectangle((-0.05, -0.05), (0.05, 0.05))
    residuals = {"continuity": 0, "momentum_x": 0, "momentum_y": 0}
    velocity = {"u": lambda out: out["u"], "v": lambda out: out["v"]}
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    pde = InteriorConstraint(equation["NavierStokes"].equations, residuals, rect, {**cfg, "batch_size": 2048},
                             MSELoss("sum"), evenly=True, weight_dict={k: 1e-4 for k in residuals}, name="EQ")
    bc_top = BoundaryConstraint(velocity, {"u": 1.0, "v": 0.0}, rect, {**cfg, "batch_size": 256}, MSELoss("sum"),
                                criteria=lambda x, y: np.isclose(y, 0.05), name="BC_top")
    bc_rest = BoundaryConstraint(velocity, {"u": 0.0, "v": 0.0}, rect, {**cfg, "batch_size": 768}, MSELoss("sum"),
                                 criteria=lambda x, y: ~np.isclose(y, 0.05), name="BC_rest")
    if lbfgs:
        optimizer = LBFGS(max_iter=10)(model)
    else:
        lr = Cosine(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3,
                    warmup_epoch=max(epochs // 20, 1))()
        optimizer = Adam(lr)(model)
    validator = {
        "residual": GeometryValidator(equation["NavierStokes"].equations, residuals, rect,
                                      {"dataset": "IterableNamedArrayDataset", "total_size": 2048}, MSELoss("sum"),
                                      metric={"MSE": MSE()}, name="residual")
    }
    return Solver(model, {c.name: c for c in (pde, bc_top, bc_rest)}, output_dir, optimizer, epochs=epochs,
                  iters_per_epoch=iters_per_epoch, validator=validator, equation=equation, log_freq=log_freq,
                  seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50, iters_per_epoch=int(argv[1]) if len(argv) > 1 else 50,
                          lbfgs=len(argv) > 2 and argv[2] == "lbfgs")
    solver.train()
    print(f"final residual MSE = {solver.eval()[0]:.4e}")
