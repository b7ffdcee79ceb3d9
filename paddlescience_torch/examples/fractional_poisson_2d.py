"""Fractional Poisson on the unit disk on the port (counterpart of
``examples/fractional_poisson_2d.py``).

(-Laplace)^(alpha / 2) u = f on the unit disk (alpha 1.8) with exact
solution u = (1 - x^2 - y^2)^(1 + alpha / 2), the boundary value hard
through the output transform u <- (1 - r^2) u. An MLP 4 x 20 (tanh); 100
Hammersley points strictly inside r < 0.95, extended by
``FractionalPoisson.precompute`` (8 directions x 40 Grünwald-Letnikov
steps) to 32,100 points whose outputs one (100, 32100) matrix on the
solver's device turns into the residual; MSE "mean"; Adam 1e-3; 200
epochs of 1 step. The validator reports the L2Rel of u on 512 random
points of the disk.

Run on the GPU: ``python -m paddlescience_torch.examples.fractional_poisson_2d [epochs]``.
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
from paddlescience_torch.equation.fpde.fractional_poisson import FractionalPoisson
from paddlescience_torch.geometry.geometry_2d import Disk
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "u_exact", "l2rel", "ALPHA"]

ALPHA = 1.8
SEED = 42


def u_exact(out):
    return np.abs(1 - (out["x"] ** 2 + out["y"] ** 2)) ** (1 + ALPHA / 2)


def build_solver(epochs: int = 200, iters_per_epoch: int = 1, output_dir: Optional[str] = "./outputs_fpde",
                 n_interior: int = 100, n_bc: int = 32, learning_rate: float = 1e-3, alpha: float = ALPHA,
                 n_theta: int = 8, n_r: int = 40, *, width: int = 20, num_layers: int = 4,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The fractional Poisson solver of the JAX example (host sampling
    seeded as there, the network's weights from a ``torch.Generator``
    seeded 42, the GL matrix on ``device``); ``n_interior``, ``n_theta``,
    ``n_r``, ``width`` and ``num_layers`` cut it for tests; ``deriv`` names
    a derivative-path candidate to pin."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x", "y"), ("u",), num_layers, width, activation="tanh",
                generator=torch.Generator().manual_seed(SEED), device=device)
    model.register_output_transform(lambda in_, out: {"u": (1 - (in_["x"] ** 2 + in_["y"] ** 2)) * out["u"]})
    geom = Disk((0, 0), 1)
    eq = FractionalPoisson(alpha, geom, (n_theta, n_r))
    pts = geom.sample_interior(4 * n_interior, random="Hammersley")
    xy = np.concatenate([pts["x"], pts["y"]], 1)
    xy = xy[np.sum(xy**2, 1) < 0.95**2][:n_interior]  # the GL rays need room to the boundary
    full_xy = eq.precompute(xy, device=device)
    fpde = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset",
                     "input": {"x": full_xy[:, :1].astype("float32"), "y": full_xy[:, 1:].astype("float32")},
                     "label": {"fpde": np.zeros((len(xy), 1), "float32")}},
         "iters_per_epoch": iters_per_epoch},
        MSELoss("mean"), {"fpde": eq.equations["fpde"]}, name="FPDE")
    validator = {
        "L2Rel": GeometryValidator({"u": lambda out: out["u"]}, {"u": u_exact}, geom,
                                   {"dataset": "NamedArrayDataset", "total_size": 512, "batch_size": 512},
                                   MSELoss("mean"), metric={"L2Rel_u": L2Rel()}, name="L2Rel")
    }
    return Solver(model, {"FPDE": fpde}, output_dir, Adam(learning_rate)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=False, validator=validator,
                  equation={"fpde": eq}, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The validator's L2Rel of u against the exact solution."""
    return solver.eval()[1]["L2Rel"]["L2Rel_u.u"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 200)
    solver.train()
    print(f"fractional Poisson L2Rel of u: {l2rel(solver):.4f}")
