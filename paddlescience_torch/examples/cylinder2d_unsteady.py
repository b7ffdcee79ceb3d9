"""2-D unsteady flow around a cylinder on the port (counterpart of
``examples/cylinder2d_unsteady.py`` and of the TIPC workload of
``bench.py::build_matched_cylinder``).

Time-dependent incompressible Navier-Stokes (nu 0.02, rho 1, Re 100) on a
channel with a cylindrical hole: ``Rectangle((-4, -4), (12, 4)) -
Disk((0, 0), 1)`` times a ``TimeDomain``. MLP 5 x 50 (tanh) from (t, x, y)
to (u, v, p). Physics only, as in the JAX example: the residual, inlet and
cylinder boundary conditions, the initial condition; the validator
reports the residuals' MSE.

* :func:`build_solver` is the example: ``TimeDomain(0, 4)``, the three
  residuals on 4096 interior points, u = 1, v = 0 at the inlet (x = -4) and
  u = v = 0 on the cylinder (512 points each), u = 1, v = 0 at t = 0 (1024
  points), each times ``iters_per_epoch`` and fed whole every step; Adam
  with a cosine schedule and a linear warmup of ``max(epochs // 20, 1)``
  epochs.
* :func:`build_matched_solver` is the TIPC workload at its full size:
  ``TimeDomain(1, 50, timestamps=31)`` (the 30 stamps after t0 are the
  sampled times), the residuals on 9420 x 30 points, inlet and cylinder on
  161 x 30, the outlet (p = 0 at x = 12) on 81 x 30, the initial condition
  on 9420; Adam at 1e-3; every batch fed whole every step: 299,280 points
  a step.

Both pin the derivative path only when ``deriv`` names one (on
``jet_pallas_full`` the 5-layer hidden stack runs as one jet segment
through the MLP kernels, zero-padded from 50 to 52 columns; the jet
carries S = 6 streams, u and its t, x, xx, y, yy components). Unpinned, as
in the JAX example, the MLP takes the plain jet path and a long
``train()`` times the candidates first.

Run on the GPU: ``python -m paddlescience_torch.examples.cylinder2d_unsteady
[epochs] [iters_per_epoch]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InitialConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import NavierStokes
from paddlescience_torch.geometry import CSGDifference, Disk, Rectangle, TimeDomain, TimeXGeometry
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "build_matched_solver", "domain", "train", "evaluate", "MATCHED"]

NU, RHO = 0.02, 1.0
# the TIPC workload (bench.py:148-207): points per time stamp and stamps
MATCHED = dict(pde=9420, inlet_cylinder=161, outlet=81, ic=9420, ntime=30)


def domain() -> CSGDifference:
    """The channel minus the cylinder."""
    return Rectangle((-4.0, -4.0), (12.0, 4.0)) - Disk((0.0, 0.0), 1.0)


def _seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)


def _model(seed: int, device) -> MLP:
    return MLP(("t", "x", "y"), ("u", "v", "p"), 5, 50, activation="tanh",
               generator=torch.Generator().manual_seed(seed), device=device)


def build_solver(epochs: int = 40, iters_per_epoch: int = 50, output_dir: Optional[str] = "./output_cylinder2d",
                 *, pde_points: int = 4096, bc_points: int = 512, ic_points: int = 1024,
                 validator_points: int = 4096, deriv: Optional[str] = None, device: DeviceLike = None,
                 seed: int = 42, log_freq: int = 200, eval_during_train: bool = False) -> Solver:
    """The cylinder2d example's solver; the batch sizes are knobs so tests
    can shrink it (the JAX example's are the defaults)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    _seed(seed)
    model = _model(seed, device)
    equation = {"NavierStokes": NavierStokes(NU, RHO, 2, True)}
    time_geom = TimeXGeometry(TimeDomain(0.0, 4.0), domain())

    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    velocity = {"u": lambda out: out["u"], "v": lambda out: out["v"]}
    pde = InteriorConstraint(equation["NavierStokes"].equations, {"continuity": 0, "momentum_x": 0, "momentum_y": 0},
                             time_geom, {**cfg, "batch_size": pde_points}, MSELoss("mean"), name="EQ")
    bc_inlet = BoundaryConstraint(velocity, {"u": 1.0, "v": 0.0}, time_geom, {**cfg, "batch_size": bc_points},
                                  MSELoss("mean"), criteria=lambda t, x, y: np.isclose(x, -4.0), name="BC_inlet")
    bc_cylinder = BoundaryConstraint(velocity, {"u": 0.0, "v": 0.0}, time_geom, {**cfg, "batch_size": bc_points},
                                     MSELoss("mean"), criteria=lambda t, x, y: (x**2 + y**2) < 1.1**2,
                                     name="BC_cylinder")
    ic = InitialConstraint(velocity, {"u": 1.0, "v": 0.0}, time_geom, {**cfg, "batch_size": ic_points},
                           MSELoss("mean"), name="IC")
    constraint = {c.name: c for c in (pde, bc_inlet, bc_cylinder, ic)}

    lr = Cosine(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3,
                warmup_epoch=max(epochs // 20, 1))()
    validator = {
        "residual": GeometryValidator(
            equation["NavierStokes"].equations,
            {"continuity": 0, "momentum_x": 0, "momentum_y": 0},
            time_geom,
            {"dataset": "IterableNamedArrayDataset", "total_size": validator_points},
            MSELoss("mean"),
            metric={"MSE": MSE()},
            name="residual",
        )
    }
    return Solver(model, constraint, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  validator=validator, equation=equation, log_freq=log_freq, eval_during_train=eval_during_train,
                  seed=seed, device=device)


def build_matched_solver(scan_steps: int, *, deriv: Optional[str] = None, device: DeviceLike = None,
                         seed: int = 42, sizes: Optional[dict] = None) -> Tuple[Solver, int]:
    """The TIPC cylinder2d workload (``bench.py::build_matched_cylinder``):
    one epoch of ``scan_steps`` steps, each on the full batch of every
    constraint. Returns ``(solver, points_per_step)``, the points counted
    from the batches' shapes. ``sizes`` overrides entries of
    :data:`MATCHED` (tests cut them)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    n = {**MATCHED, **(sizes or {})}
    _seed(seed)
    model = _model(seed, device)
    equation = {"NavierStokes": NavierStokes(NU, RHO, 2, True)}
    timestamps = np.linspace(1.0, 50.0, n["ntime"] + 1).astype(np.float32)
    time_geom = TimeXGeometry(TimeDomain(1.0, 50.0, timestamps=timestamps), domain())

    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": 1}
    pde = InteriorConstraint(equation["NavierStokes"].equations, {"continuity": 0, "momentum_x": 0, "momentum_y": 0},
                             time_geom, {**cfg, "batch_size": n["pde"] * n["ntime"]}, MSELoss("mean"), name="EQ")
    bc_inlet_cyl = BoundaryConstraint(
        {"u": lambda out: out["u"], "v": lambda out: out["v"]}, {"u": 1.0, "v": 0.0}, time_geom,
        {**cfg, "batch_size": n["inlet_cylinder"] * n["ntime"]}, MSELoss("mean"),
        criteria=lambda t, x, y: np.isclose(x, -4.0) | ((x**2 + y**2) < 1.1**2), name="BC_inlet_cylinder")
    bc_outlet = BoundaryConstraint(
        {"p": lambda out: out["p"]}, {"p": 0.0}, time_geom, {**cfg, "batch_size": n["outlet"] * n["ntime"]},
        MSELoss("mean"), criteria=lambda t, x, y: np.isclose(x, 12.0), name="BC_outlet")
    ic = InitialConstraint({"u": lambda out: out["u"], "v": lambda out: out["v"]}, {"u": 1.0, "v": 0.0}, time_geom,
                           {**cfg, "batch_size": n["ic"]}, MSELoss("mean"), name="IC")
    constraint = {c.name: c for c in (pde, bc_inlet_cyl, bc_outlet, ic)}
    solver = Solver(model, constraint, None, Adam(1e-3)(model), epochs=1, iters_per_epoch=scan_steps,
                    log_freq=10**9, equation=equation, seed=seed, device=device)
    points = sum(next(iter(batch[0].values())).shape[0] for batch in solver._static_batches.values())
    return solver, points


def train(**kwargs) -> float:
    """Train a :func:`build_solver` solver (``kwargs`` are its arguments),
    evaluate it and return the residuals' MSE."""
    solver = build_solver(**kwargs)
    solver.train()
    metric, _ = solver.eval()
    print(f"final residual MSE = {metric:.4e}")
    return metric


def evaluate(pretrained_model_path: Optional[str] = None, **kwargs) -> float:
    """The residuals' MSE of a :func:`build_solver` model, with the
    parameters of the checkpoint at ``pretrained_model_path`` if given."""
    solver = build_solver(**kwargs)
    if pretrained_model_path:
        solver.load_pretrain(pretrained_model_path)
    metric, _ = solver.eval()
    print(f"eval residual MSE = {metric:.4e}")
    return metric


if __name__ == "__main__":
    argv = sys.argv[1:]
    train(epochs=int(argv[0]) if argv else 40, iters_per_epoch=int(argv[1]) if len(argv) > 1 else 50)
