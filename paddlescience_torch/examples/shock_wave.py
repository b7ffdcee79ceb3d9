"""PINN-WE for the 2-D compressible Euler equations on the port
(counterpart of ``examples/shock_wave.py``).

A Sod-type shock tube in the box (x, y) in [0, 1] x [0, 0.25], t in [0,
0.2], gamma = 1.4. The four Euler residuals are user closures over
``ad.jacobian`` of composed expressions (rho u, rho u^2 + p, the energy
flux, ...), each divided by the weighted-equation factor lam = 1 + 0.1
relu_factor (|div u| - div u), which down-weights compression shocks
(``abs`` of a derivative). An MLP 5 x 64 (tanh) maps (t, x, y) to (u, v,
p, rho); the residuals on 1024 x 20 interior points (sampled once and fed
whole every step; ``sample_iters`` cuts it), the Sod initial state on
1024 points with weight 10, MSE "mean"; Adam 1e-3; 20 epochs of 20 steps.
:func:`density_jump` is the JAX example's report: rho at t = 0 left and
right of the diaphragm (true 1 and 0.125).

Run on the GPU: ``python -m paddlescience_torch.examples.shock_wave [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import ad
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import InteriorConstraint, SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.base import PDE
from paddlescience_torch.geometry.geometry_2d import Rectangle
from paddlescience_torch.geometry.timedomain import TimeDomain, TimeXGeometry
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "make_euler2d", "density_jump"]

ITERS = 20  # the example's iterations an epoch
SEED = 42


def make_euler2d(relu_factor: float = 1.0) -> PDE:
    """The Euler system with the shock weighting lam (the JAX example's
    closures, term for term)."""
    eq = PDE()

    def lam(out):
        u__x = ad.jacobian(out["u"], out["x"])
        v__y = ad.jacobian(out["v"], out["y"])
        delta = u__x + v__y
        return (0.1 * (abs(delta) - delta)) * relu_factor + 1.0

    def continuity(out):
        t, x, y = out["t"], out["x"], out["y"]
        u, v, rho = out["u"], out["v"], out["rho"]
        return (ad.jacobian(rho, t) + ad.jacobian(rho * u, x) + ad.jacobian(rho * v, y)) / lam(out)

    def x_momentum(out):
        t, x, y = out["t"], out["x"], out["y"]
        u, v, p, rho = out["u"], out["v"], out["p"], out["rho"]
        return (ad.jacobian(rho * u, t) + ad.jacobian(rho * u**2 + p, x)
                + ad.jacobian(rho * u * v, y)) / lam(out)

    def y_momentum(out):
        t, x, y = out["t"], out["x"], out["y"]
        u, v, p, rho = out["u"], out["v"], out["p"], out["rho"]
        return (ad.jacobian(rho * v, t) + ad.jacobian(rho * u * v, x)
                + ad.jacobian(rho * v**2 + p, y)) / lam(out)

    def energy(out):
        t, x, y = out["t"], out["x"], out["y"]
        u, v, p, rho = out["u"], out["v"], out["p"], out["rho"]
        ke = rho * 0.5 * (u**2 + v**2)
        return (ad.jacobian(ke + p / 0.4, t) + ad.jacobian((ke + 3.5 * p) * u, x)
                + ad.jacobian((ke + 3.5 * p) * v, y)) / lam(out)

    eq.add_equation("continuity", continuity)
    eq.add_equation("x_momentum", x_momentum)
    eq.add_equation("y_momentum", y_momentum)
    eq.add_equation("energy", energy)
    return eq


def build_solver(epochs: int = 20, output_dir: Optional[str] = "./output_shock_wave", *,
                 sample_iters: Optional[int] = None, n_interior: int = 1024, width: int = 64, num_layers: int = 5,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The shock-tube solver of the JAX example (host data seeded as there,
    the network's weights from a ``torch.Generator`` seeded 42);
    ``sample_iters``, ``n_interior``, ``width``, ``num_layers`` and
    ``deriv`` as for ``examples/burgers.py``."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("t", "x", "y"), ("u", "v", "p", "rho"), num_layers, width, activation="tanh",
                generator=torch.Generator().manual_seed(SEED), device=device)
    equation = {"Euler2D": make_euler2d()}
    geom = TimeXGeometry(TimeDomain(0.0, 0.2), Rectangle((0, 0), (1, 0.25)))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": ITERS if sample_iters is None else sample_iters}
    eqs = equation["Euler2D"].equations
    interior = InteriorConstraint(eqs, {k: 0 for k in eqs}, geom, {**cfg, "batch_size": n_interior},
                                  MSELoss("mean"), name="EQ")
    # the Sod state at t = 0: left (rho 1, p 1), right (rho 0.125, p 0.1), at rest
    rng = np.random.default_rng(0)
    n0 = 1024
    x0 = rng.uniform(0, 1, (n0, 1)).astype(np.float32)
    y0 = rng.uniform(0, 0.25, (n0, 1)).astype(np.float32)
    t0 = np.zeros((n0, 1), np.float32)
    left = (x0 < 0.5).astype(np.float32)
    ic = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t": t0, "x": x0, "y": y0},
                     "label": {"u": np.zeros_like(x0), "v": np.zeros_like(x0), "p": 1.0 * left + 0.1 * (1 - left),
                               "rho": 1.0 * left + 0.125 * (1 - left)},
                     "weight": {k: np.full_like(x0, 10.0) for k in ("u", "v", "p", "rho")}}},
        MSELoss("mean"), {k: (lambda out, kk=k: out[kk]) for k in ("u", "v", "p", "rho")}, name="IC")
    return Solver(model, {"EQ": interior, "IC": ic}, output_dir, Adam(1e-3)(model), epochs=epochs,
                  iters_per_epoch=ITERS, equation=equation, log_freq=100, seed=SEED, device=device)


def density_jump(solver: Solver) -> Tuple[float, float]:
    """The mean rho at t = 0, y = 0.125 over the 16 leftmost and the 16
    rightmost of 64 points across the tube (true 1 and 0.125)."""
    x = np.linspace(0, 1, 64, dtype=np.float32).reshape(-1, 1)
    rho = solver.predict({"x": x, "y": np.full_like(x, 0.125), "t": np.zeros_like(x)}, return_numpy=True)["rho"]
    return float(rho[:16].mean()), float(rho[-16:].mean())


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 20)
    solver.train()
    left, right = density_jump(solver)
    print(f"shock tube: rho(left)={left:.3f} (true 1.0), rho(right)={right:.3f} (true 0.125)")
