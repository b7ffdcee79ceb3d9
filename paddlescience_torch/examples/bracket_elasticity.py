"""3-D linear elasticity on a cantilever block on the port (counterpart of
``examples/bracket_elasticity.py``).

A displacement network (u, v, w) and a stress network (the six sigma_ij),
two MLPs 4 x 64 (tanh) in a ``ModelList``, solve the nine-equation mixed
form of ``LinearElasticity(lambda_=1.5, mu=1.0, dim=3)`` on the Cuboid [0, 2]
x [0, 0.5] x [0, 0.5]: fixed at x = 0, a traction pulling down (-0.1 in z)
at x = 2, traction-free elsewhere. Each constraint samples ``batch_size x
iters_per_epoch`` points once, as the JAX example's, and feeds them all
every step: 1024 interior, 128 fixed, 128 loaded and 512 free boundary
points per iteration of an epoch. MSE "sum" losses summed; Adam with
ExponentialDecay (1e-3, gamma 0.95 over a twentieth of the run).

Run on the GPU: ``python -m paddlescience_torch.examples.bracket_elasticity [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.arch.model_list import ModelList
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import LinearElasticity
from paddlescience_torch.geometry import Cuboid
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "tip_deflection", "STRESS_KEYS", "RESIDUAL_KEYS"]

STRESS_KEYS = ("sigma_xx", "sigma_yy", "sigma_zz", "sigma_xy", "sigma_xz", "sigma_yz")
RESIDUAL_KEYS = ("stress_disp_xx", "stress_disp_yy", "stress_disp_zz", "stress_disp_xy", "stress_disp_xz",
                 "stress_disp_yz", "equilibrium_x", "equilibrium_y", "equilibrium_z")


def build_solver(epochs: int = 30, iters_per_epoch: int = 20, output_dir: Optional[str] = "./output_bracket", *,
                 deriv: Optional[str] = None, device: DeviceLike = None, seed: int = 42, width: int = 64,
                 num_layers: int = 4, log_freq: int = 100) -> Solver:
    """The bracket solver of the JAX example (host sampling seeded with
    ``seed``, each network's weights from a ``torch.Generator``);
    ``width``/``num_layers`` cut the networks for tests; ``deriv`` names a
    derivative-path candidate to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(seed)
    random.seed(seed)
    disp_net = MLP(("x", "y", "z"), ("u", "v", "w"), num_layers, width,
                   generator=torch.Generator().manual_seed(seed), device=device)
    stress_net = MLP(("x", "y", "z"), STRESS_KEYS, num_layers, width,
                     generator=torch.Generator().manual_seed(seed + 1), device=device)
    model = ModelList((disp_net, stress_net))
    equation = {"LinearElasticity": LinearElasticity(E=None, nu=0.3, lambda_=1.5, mu=1.0, dim=3)}
    geom = Cuboid((0.0, 0.0, 0.0), (2.0, 0.5, 0.5))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    eqs = equation["LinearElasticity"].equations
    traction = {k: eqs[k] for k in ("traction_x", "traction_y", "traction_z")}
    interior = InteriorConstraint(eqs, {k: 0 for k in RESIDUAL_KEYS}, geom, {**cfg, "batch_size": 1024},
                                  MSELoss("sum"), name="INTERIOR")
    bc_fixed = BoundaryConstraint({k: (lambda d, kk=k: d[kk]) for k in ("u", "v", "w")}, {"u": 0, "v": 0, "w": 0},
                                  geom, {**cfg, "batch_size": 128}, MSELoss("sum"),
                                  criteria=lambda x, y, z: np.isclose(x, 0.0), name="BC_FIXED")
    bc_load = BoundaryConstraint(traction, {"traction_x": 0, "traction_y": 0, "traction_z": -0.1}, geom,
                                 {**cfg, "batch_size": 128}, MSELoss("sum"),
                                 criteria=lambda x, y, z: np.isclose(x, 2.0), name="BC_LOAD")
    bc_free = BoundaryConstraint(traction, {"traction_x": 0, "traction_y": 0, "traction_z": 0}, geom,
                                 {**cfg, "batch_size": 512}, MSELoss("sum"),
                                 criteria=lambda x, y, z: ~(np.isclose(x, 0.0) | np.isclose(x, 2.0)), name="BC_FREE")
    lr = ExponentialDecay(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3, gamma=0.95,
                          decay_steps=max(epochs * iters_per_epoch // 20, 1))()
    return Solver(model, {c.name: c for c in (interior, bc_fixed, bc_load, bc_free)}, output_dir,
                  Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch, equation=equation,
                  log_freq=log_freq, seed=seed, device=device)


def tip_deflection(solver: Solver) -> float:
    """The mean w on 16 points along z at the loaded end (x = 2, y = 0.25):
    negative under the downward load."""
    pred = solver.predict({"x": np.full((16, 1), 2.0, np.float32), "y": np.full((16, 1), 0.25, np.float32),
                           "z": np.linspace(0, 0.5, 16, dtype=np.float32).reshape(-1, 1)}, return_numpy=True)
    return float(pred["w"].mean())


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 30)
    solver.train()
    print(f"tip w mean = {tip_deflection(solver):.4e} (should be < 0 under downward load)")
