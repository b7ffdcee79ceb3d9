"""Biharmonic plate bending on the port (counterpart of
``examples/biharmonic2d.py``).

lap(lap(w)) = q / D on the unit square, a simply supported plate under
q = q0 sin(pi x) sin(pi y), whose Navier solution is
w = q0 / (4 pi^4 D) sin(pi x) sin(pi y). An MLP 4 x 32 (tanh) with the
output transform w = x (1 - x) y (1 - y) net(x, y), which puts w = 0 on the
boundary: a transformed net has no jet forward, so the fourth-order
components come from nested jvp of the transformed call. The residual on
1024 x 25 interior points (sampled once and fed whole every step;
``sample_iters`` cuts it), MSE "sum"; Adam 2e-3; 40 epochs of 25 steps.
:func:`l2rel` scores w on a 32 x 32 grid against the Navier solution.

Run on the GPU: ``python -m paddlescience_torch.examples.biharmonic2d [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import Biharmonic
from paddlescience_torch.geometry import Rectangle
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "w_exact", "l2rel"]

A, Q0, D = 1.0, 1.0, 1.0
W0 = Q0 * A**4 / (4 * np.pi**4 * D)
ITERS = 25
SEED = 42


def w_exact(x, y):
    return W0 * np.sin(np.pi * x / A) * np.sin(np.pi * y / A)


def build_solver(epochs: int = 40, output_dir: Optional[str] = "./output_biharmonic2d", *,
                 sample_iters: Optional[int] = None, batch_size: int = 1024, width: int = 32, num_layers: int = 4,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The plate solver of the JAX example (host sampling seeded as there,
    the network's weights from a ``torch.Generator`` seeded 42);
    ``sample_iters`` sets the iterations the interior samples for (None:
    the example's 25); ``batch_size``, ``width`` and ``num_layers`` cut it
    for tests; ``deriv`` names a derivative-path candidate to pin."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x", "y"), ("u",), num_layers, width, generator=torch.Generator().manual_seed(SEED), device=device)
    model.register_output_transform(
        lambda inp, out: {"u": inp["x"] * (A - inp["x"]) * inp["y"] * (A - inp["y"]) * out["u"]})
    equation = {"Biharmonic": Biharmonic(dim=2, q=0.0, D=D)}
    geom = Rectangle((0.0, 0.0), (A, A))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": ITERS if sample_iters is None else sample_iters}
    interior = InteriorConstraint(
        equation["Biharmonic"].equations,
        {"biharmonic": lambda d: (Q0 / D) * np.sin(np.pi * d["x"] / A) * np.sin(np.pi * d["y"] / A)},
        geom, {**cfg, "batch_size": batch_size}, MSELoss("sum"), name="EQ")
    return Solver(model, {"EQ": interior}, output_dir, Adam(2e-3)(model), epochs=epochs, iters_per_epoch=ITERS,
                  equation=equation, log_freq=200, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The relative L2 error of w on a 32 x 32 grid (the JAX example's report)."""
    x, y = np.meshgrid(np.linspace(0, A, 32), np.linspace(0, A, 32), indexing="ij")
    pred = solver.predict({"x": x.reshape(-1, 1).astype(np.float32), "y": y.reshape(-1, 1).astype(np.float32)},
                          return_numpy=True)["u"]
    truth = w_exact(x.reshape(-1, 1), y.reshape(-1, 1))
    return float(np.linalg.norm(pred - truth) / np.linalg.norm(truth))


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 40)
    solver.train()
    print(f"biharmonic plate L2Rel vs Navier solution: {l2rel(solver):.4f}")
