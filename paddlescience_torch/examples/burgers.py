"""1-D viscous Burgers PINN on the port (counterpart of
``examples/burgers.py``).

u_t + u u_x = nu u_xx on (t, x) in [0, 1] x [-1, 1], u(0, x) = -sin(pi x),
u(t, +-1) = 0, nu = 0.01 / pi. The residual is a user closure over
``ad.jacobian``/``ad.hessian`` on the generic ``PDE()``, the advection term
a product of the network's output and its derivative. An MLP 4 x 64
(tanh); the residual on 2048 x 50 interior points (sampled once and fed
whole every step, as the JAX example's dataloader configuration does;
``sample_iters`` cuts it), the initial condition on 512 points and the
boundary on 256, MSE "mean"; Adam 1e-3; 40 epochs of 50 steps.
:func:`l2rel` scores the trained network against the Fourier
pseudo-spectral reference (:func:`solve_burgers_spectral`, RK4 in time,
the JAX example's solver in numpy).

Run on the GPU: ``python -m paddlescience_torch.examples.burgers [epochs]``.
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
from paddlescience_torch.constraint.constraints import InteriorConstraint, SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.base import PDE
from paddlescience_torch.geometry.geometry_1d import Interval
from paddlescience_torch.geometry.timedomain import TimeDomain, TimeXGeometry
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "solve_burgers_spectral", "l2rel", "NU"]

NU = 0.01 / np.pi
ITERS = 50  # the example's iterations an epoch
SEED = 42


def solve_burgers_spectral(nx=256, nt=101, t_max=1.0):
    """(t, x, u) of the Fourier pseudo-spectral solution with RK4 in time:
    u is (nt, nx) on the periodic grid x in [-1, 1)."""
    x = np.linspace(-1, 1, nx, endpoint=False)
    k = np.fft.fftfreq(nx, d=2.0 / nx) * 2 * np.pi / 2.0 * 2  # wavenumbers on [-1, 1)
    u = -np.sin(np.pi * x)
    dt = t_max / (nt - 1) / 20
    us = [u.copy()]

    def rhs(u):
        uh = np.fft.fft(u)
        ux = np.real(np.fft.ifft(1j * k * uh))
        uxx = np.real(np.fft.ifft(-(k**2) * uh))
        return -u * ux + NU * uxx

    t_save = np.linspace(0, t_max, nt)
    t = 0.0
    for i in range(1, nt):
        while t < t_save[i] - 1e-12:
            k1 = rhs(u)
            k2 = rhs(u + 0.5 * dt * k1)
            k3 = rhs(u + 0.5 * dt * k2)
            k4 = rhs(u + dt * k3)
            u = u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            t += dt
        us.append(u.copy())
    return t_save, x, np.stack(us)


def build_solver(epochs: int = 40, output_dir: Optional[str] = "./output_burgers", *,
                 sample_iters: Optional[int] = None, n_interior: int = 2048, width: int = 64, num_layers: int = 4,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The Burgers solver of the JAX example (host data seeded as there, the
    network's weights from a ``torch.Generator`` seeded 42).
    ``sample_iters`` sets the iterations the interior samples for (None:
    the example's 50); ``n_interior``, ``width`` and ``num_layers`` cut it
    for tests; ``deriv`` names a derivative-path candidate to pin (None:
    none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("t", "x"), ("u",), num_layers, width, generator=torch.Generator().manual_seed(SEED),
                device=device)

    def burgers_residual(out):
        u, t, x = out["u"], out["t"], out["x"]
        return ad.jacobian(u, t) + u * ad.jacobian(u, x) - NU * ad.hessian(u, x)

    eq = PDE()
    eq.add_equation("burgers", burgers_residual)
    geom = TimeXGeometry(TimeDomain(0.0, 1.0), Interval(-1.0, 1.0))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": ITERS if sample_iters is None else sample_iters}
    interior = InteriorConstraint(eq.equations, {"burgers": 0}, geom, {**cfg, "batch_size": n_interior},
                                  MSELoss("mean"), name="EQ")
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (512, 1)).astype(np.float32)
    ic = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t": np.zeros_like(x0), "x": x0},
                     "label": {"u": -np.sin(np.pi * x0)}}},
        MSELoss("mean"), {"u": lambda out: out["u"]}, name="IC")
    tb = rng.uniform(0, 1, (256, 1)).astype(np.float32)
    xb = np.where(rng.random((256, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    bc = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t": tb, "x": xb},
                     "label": {"u": np.zeros_like(tb)}}},
        MSELoss("mean"), {"u": lambda out: out["u"]}, name="BC")
    return Solver(model, {"EQ": interior, "IC": ic, "BC": bc}, output_dir, Adam(1e-3)(model), epochs=epochs,
                  iters_per_epoch=ITERS, equation={"burgers": eq}, log_freq=500, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The relative L2 error of u against the spectral reference on its
    101 x 256 grid (the JAX example's report)."""
    t_ref, x_ref, u_ref = solve_burgers_spectral()
    T, X = np.meshgrid(t_ref, x_ref, indexing="ij")
    pred = solver.predict({"t": T.reshape(-1, 1).astype(np.float32), "x": X.reshape(-1, 1).astype(np.float32)},
                          return_numpy=True)["u"]
    return float(np.linalg.norm(pred.ravel() - u_ref.ravel()) / np.linalg.norm(u_ref))


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 40)
    solver.train()
    print(f"Burgers L2Rel vs spectral reference: {l2rel(solver):.4f}")
