"""The quick-start cases on the port (counterpart of
``examples/quick_start.py``).

* case 1: fit u = sin(x) on [-pi, pi] through an interior constraint
  (3200 points, shuffled batches of 32; MLP 3 x 64, tanh; Adam 2e-3;
  10 epochs of 100 steps);
* case 2: the ODE du/dx = cos(x) with u(-pi) = sin(-pi) + 2, the
  derivative taken on the tape (the same sizes, one boundary point a
  step);
* case 3: Kirchhoff plate bending, w_xxxx + 2 w_xxyy + w_yyyy = q / D on
  [-1, 1] x [-0.5, 0.5], simply supported on the x edges (w = w_xx = 0)
  and free on the y edges (w_yy + mu w_xx = 0, w_yyy + (2 - mu) w_xxy = 0);
  20,000 Halton interior points and 10,000 on each pair of edges; MLP 4 x
  50 (tanh); L-BFGS (20 line-search trials a step), 50 steps. The JAX
  example writes these in sympy; here they are closures of order-4
  derivatives on the tape (:class:`KirchhoffPlate`: nested jvp above
  order 2, the jet below).

:func:`run_1d_case` returns the L2Rel of u against the exact solution on
1000 points, :func:`run_case3` the largest deflection on a 101^2 grid.

Run on the GPU: ``python -m paddlescience_torch.examples.quick_start [case] [epochs]``.
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
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.base import PDE
from paddlescience_torch.geometry import Rectangle
from paddlescience_torch.geometry.geometry_1d import Interval
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import LBFGS, Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_case1", "build_case2", "build_case3", "run_1d_case", "run_case3", "KirchhoffPlate"]

SEED = 42
LX, LY = 2.0, 1.0
E, MU, H, Q = 210000.0e6, 0.28, 0.01, 1000.0
D = E * H**3 / (12 * (1 - MU**2))


def _setup(deriv, device):
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    return device


def _loader(iters_per_epoch, batch_size):
    return {"dataset": "NamedArrayDataset", "iters_per_epoch": iters_per_epoch,
            "sampler": {"name": "BatchSampler", "shuffle": True}, "batch_size": batch_size}


def build_case1(epochs: int = 10, iters_per_epoch: int = 100, output_dir: Optional[str] = "./outputs_quick_start",
                *, width: int = 64, num_layers: int = 3, deriv: Optional[str] = None, device: DeviceLike = None):
    """(solver, exact solution) of case 1."""
    device = _setup(deriv, device)
    x_domain = Interval(-np.pi, np.pi)
    model = MLP(("x",), ("u",), num_layers, width, generator=torch.Generator().manual_seed(SEED), device=device)
    interior = InteriorConstraint({"u": lambda out: out["u"]}, {"u": lambda d: np.sin(d["x"])}, x_domain,
                                  _loader(iters_per_epoch, 32), MSELoss())
    solver = Solver(model, {interior.name: interior}, output_dir, Adam(2e-3)(model), epochs=epochs,
                    iters_per_epoch=iters_per_epoch, seed=SEED, device=device)
    return solver, np.sin


def build_case2(epochs: int = 10, iters_per_epoch: int = 100, output_dir: Optional[str] = "./outputs_quick_start",
                *, width: int = 64, num_layers: int = 3, deriv: Optional[str] = None, device: DeviceLike = None):
    """(solver, exact solution) of case 2."""
    device = _setup(deriv, device)
    x_domain = Interval(-np.pi, np.pi)
    model = MLP(("x",), ("u",), num_layers, width, generator=torch.Generator().manual_seed(SEED), device=device)
    interior = InteriorConstraint({"du_dx": lambda out: ad.jacobian(out["u"], out["x"])},
                                  {"du_dx": lambda d: np.cos(d["x"])}, x_domain, _loader(iters_per_epoch, 32),
                                  MSELoss())
    bc = BoundaryConstraint({"u": lambda d: d["u"]}, {"u": lambda d: np.sin(d["x"]) + 2}, x_domain,
                            _loader(iters_per_epoch, 1), MSELoss(), criteria=lambda x: np.isclose(x, -np.pi))
    solver = Solver(model, {interior.name: interior, bc.name: bc}, output_dir, Adam(2e-3)(model), epochs=epochs,
                    iters_per_epoch=iters_per_epoch, seed=SEED, device=device)
    return solver, lambda x: np.sin(x) + 2.0


def run_1d_case(solver: Solver, ref) -> float:
    """Train, then the L2Rel of u on 1000 points of [-pi, pi]."""
    solver.train()
    x = np.linspace(-np.pi, np.pi, 1000, dtype="float32").reshape(1000, 1)
    pred = solver.predict({"x": x}, batch_size=1000, return_numpy=True)["u"]
    u_ref = ref(x)
    return float(np.linalg.norm(pred - u_ref) / np.linalg.norm(u_ref))


class KirchhoffPlate(PDE):
    """The plate's residual and edge conditions as closures over w's
    derivatives (``PDE.d``: the jet up to order 2, nested jvp above)."""

    def __init__(self):
        super().__init__()
        d = lambda out, *axes: self.d(out, "w", *axes)
        self.add_equation("kirchhoff_res", lambda out: d(out, "x", "x", "x", "x") + 2 * d(out, "x", "x", "y", "y")
                          + d(out, "y", "y", "y", "y") - Q / D)
        self.add_equation("w", lambda out: d(out))
        self.add_equation("ddw_dxx", lambda out: d(out, "x", "x"))
        self.add_equation("item1", lambda out: d(out, "y", "y") + MU * d(out, "x", "x"))
        self.add_equation("item2", lambda out: d(out, "y", "y", "y") + (2 - MU) * d(out, "x", "x", "y"))


def build_case3(epochs: int = 50, iters_per_epoch: int = 1, output_dir: Optional[str] = "./outputs_quick_start",
                n_interior: int = 20000, n_bc: int = 10000, max_iter: int = 20, *, width: int = 50,
                num_layers: int = 4, deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The Kirchhoff plate solver (trained with L-BFGS)."""
    device = _setup(deriv, device)
    rect = Rectangle((-LX / 2, -LY / 2), (LX / 2, LY / 2))
    model = MLP(("x", "y"), ("w",), num_layers, width, activation="tanh",
                generator=torch.Generator().manual_seed(SEED), device=device)
    plate = KirchhoffPlate()
    eqs = plate.equations
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    pde = InteriorConstraint({"kirchhoff_res": eqs["kirchhoff_res"]}, {"kirchhoff_res": 0.0}, rect,
                             {**cfg, "batch_size": n_interior}, MSELoss(), random="Halton", name="EQ")
    lr_edges = BoundaryConstraint({"w": eqs["w"], "ddw_dxx": eqs["ddw_dxx"]}, {"w": 0, "ddw_dxx": 0}, rect,
                                  {**cfg, "batch_size": n_bc}, MSELoss(),
                                  criteria=lambda x, y: np.isclose(x, -LX / 2) | np.isclose(x, LX / 2), name="BC_lr")
    ud_edges = BoundaryConstraint({"item1": eqs["item1"], "item2": eqs["item2"]}, {"item1": 0.0, "item2": 0.0}, rect,
                                  {**cfg, "batch_size": n_bc}, MSELoss(),
                                  criteria=lambda x, y: np.isclose(y, -LY / 2) | np.isclose(y, LY / 2), name="BC_ud")
    return Solver(model, {"EQ": pde, "BC_lr": lr_edges, "BC_ud": ud_edges}, output_dir,
                  LBFGS(max_iter=max_iter)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  equation={"Kirchhoff": plate}, seed=SEED, device=device)


def run_case3(solver: Solver) -> float:
    """Train, then the largest |w| on a 101^2 grid of the plate."""
    solver.train()
    n = 101
    gx, gy = np.meshgrid(np.linspace(-1.0, 1.0, n, dtype="float32"), np.linspace(-0.5, 0.5, n, dtype="float32"))
    w = solver.predict({"x": gx.reshape(-1, 1), "y": gy.reshape(-1, 1)}, batch_size=n * n, return_numpy=True)["w"]
    return float(np.abs(w).max())


if __name__ == "__main__":
    argv = sys.argv[1:]
    case = int(argv[0]) if argv else 1
    if case == 3:
        print(f"case3 max |w| = {run_case3(build_case3(int(argv[1]) if len(argv) > 1 else 50)):.4e} m")
    else:
        build = build_case1 if case == 1 else build_case2
        print(f"case{case} l2_rel = {run_1d_case(*build(int(argv[1]) if len(argv) > 1 else 10)):.5f}")
