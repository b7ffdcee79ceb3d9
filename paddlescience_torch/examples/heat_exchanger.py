"""1-D heat exchanger three-temperature system on the port (counterpart of
``examples/heat_exchanger.py``).

T_h, T_c, T_w over (x, t) and the mass flows (qm_h, qm_c) with
``HeatExchanger(1, 1, 1, 1, 1, 1)``: an MLP 4 x 50 (tanh) maps (x, t,
qm_h, qm_c) to the three temperatures. Every term is a supervised
constraint on fixed points drawn from seeded generators: the three
residuals on 2048 points (a ``SupervisedConstraint`` whose output
expressions are the equations, labels 0), the hot inlet T_h = 1 at x = 0
and the cold inlet T_c = 0 at x = 1 (256 points each), the initial state
0.5 at t = 0 (512 points), MSE "mean"; Adam 1e-3; 30 epochs of 20 steps.
The JAX example reports no metric beyond its losses; :func:`final_loss`
reads the last logged one.

Run on the GPU: ``python -m paddlescience_torch.examples.heat_exchanger [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.extra import HeatExchanger
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "sample", "final_loss"]

SEED = 42
L, T_END = 1.0, 1.0


def sample(n: int, t_zero: bool = False, x_edge: Optional[float] = None, seed_shift: int = 0):
    """n points (x, t, qm_h, qm_c) from ``np.random.default_rng(seed_shift)``:
    x in [0, L] (or the edge ``x_edge``), t in [0, T_END] (or 0), the flows
    in [0.5, 1.5]."""
    rng = np.random.default_rng(0 + seed_shift)
    x = rng.uniform(0, L, (n, 1)).astype(np.float32)
    t = np.zeros((n, 1), np.float32) if t_zero else rng.uniform(0, T_END, (n, 1)).astype(np.float32)
    if x_edge is not None:
        x = np.full((n, 1), x_edge, np.float32)
    qm = rng.uniform(0.5, 1.5, (n, 2)).astype(np.float32)
    return {"x": x, "t": t, "qm_h": qm[:, :1], "qm_c": qm[:, 1:]}


def build_solver(epochs: int = 30, iters_per_epoch: int = 20, output_dir: Optional[str] = "./output_heat_exchanger",
                 *, width: int = 50, num_layers: int = 4, deriv: Optional[str] = None,
                 device: DeviceLike = None) -> Solver:
    """The heat-exchanger solver of the JAX example (the network's weights
    from a ``torch.Generator`` seeded 42); ``width`` and ``num_layers`` cut
    it for tests; ``deriv`` names a derivative-path candidate to pin (None:
    none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x", "t", "qm_h", "qm_c"), ("T_h", "T_c", "T_w"), num_layers, width,
                generator=torch.Generator().manual_seed(SEED), device=device)
    equation = {"heat": HeatExchanger(1.0, 1.0, 1.0, 1.0, 1.0, 1.0)}
    eqs = equation["heat"].equations
    ds = lambda inp, label: {"dataset": {"name": "IterableNamedArrayDataset", "input": inp, "label": label}}
    pde = SupervisedConstraint(ds(sample(2048), {k: np.zeros((2048, 1), np.float32) for k in eqs}),
                               MSELoss("mean"), eqs, name="EQ")
    bc_h = SupervisedConstraint(ds(sample(256, x_edge=0.0, seed_shift=1), {"T_h": np.ones((256, 1), np.float32)}),
                                MSELoss("mean"), {"T_h": lambda out: out["T_h"]}, name="BC_hot")
    bc_c = SupervisedConstraint(ds(sample(256, x_edge=L, seed_shift=2), {"T_c": np.zeros((256, 1), np.float32)}),
                                MSELoss("mean"), {"T_c": lambda out: out["T_c"]}, name="BC_cold")
    ic = SupervisedConstraint(ds(sample(512, t_zero=True, seed_shift=3),
                                 {k: 0.5 * np.ones((512, 1), np.float32) for k in ("T_h", "T_c", "T_w")}),
                              MSELoss("mean"), {k: (lambda out, kk=k: out[kk]) for k in ("T_h", "T_c", "T_w")},
                              name="IC")
    constraint = {c.name: c for c in (pde, bc_h, bc_c, ic)}
    return Solver(model, constraint, output_dir, Adam(1e-3)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  equation=equation, log_freq=100, seed=SEED, device=device)


def final_loss(logged) -> float:
    """The last loss that ``Solver.train`` logged."""
    return float(logged[-1]["loss"])


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 30)
    print(f"heat exchanger final loss: {final_loss(solver.train()):.6e}")
