"""Gradient-enhanced PINN for a 1-D Poisson problem on the port
(counterpart of ``examples/gpinn.py``).

-u'' = f on (0, pi) with f = 8 sin(8x) + sum_{i=1..4} i sin(ix), and the
gradient-enhanced residual -u''' = f' weighted 0.01. The boundary values
are hard: the output transform u <- x + tanh(x) tanh(pi - x) u. An MLP 3 x
20 (tanh); the two residuals on 15 evenly spaced points, MSE "mean"; Adam
1e-3; 20000 epochs of 1 step. The JAX example's sympy ``gPINN1D`` is the
closure PDE :class:`GPINN1D`: both residuals read u's derivatives through
``PDE.d``, the third-order one from nested jvp (the transformed net has no
jet). The validator reports the L2Rel of u on 100 evenly spaced points.

Run on the GPU: ``python -m paddlescience_torch.examples.gpinn [epochs]``.
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
from paddlescience_torch.constraint.constraints import InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.base import PDE
from paddlescience_torch.geometry.geometry_1d import Interval
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["GPINN1D", "build_solver", "u_solution", "l2rel"]

SEED = 42


class GPINN1D(PDE):
    """res1 = -u'' - f and res2 = -u''' - f' (the JAX example's sympy form)."""

    def __init__(self, invar: str = "x", outvar: str = "u"):
        super().__init__()

        def f(x):
            s = 8 * torch.sin(8 * x)
            for i in range(1, 5):
                s = s + i * torch.sin(i * x)
            return s

        def df(x):
            return torch.cos(x) + 4 * torch.cos(2 * x) + 9 * torch.cos(3 * x) + 16 * torch.cos(4 * x) \
                + 64 * torch.cos(8 * x)

        self.add_equation("res1", lambda out: -self.d(out, outvar, invar, invar) - f(ad.unwrap(out[invar])))
        self.add_equation("res2", lambda out: -self.d(out, outvar, invar, invar, invar) - df(ad.unwrap(out[invar])))


def u_solution(in_):
    x = in_["x"]
    sol = x + 1 / 8 * np.sin(8 * x)
    for i in range(1, 5):
        sol += 1 / i * np.sin(i * x)
    return sol


def build_solver(epochs: int = 20000, iters_per_epoch: int = 1, output_dir: Optional[str] = "./outputs_gpinn",
                 npoint_pde: int = 15, npoint_eval: int = 100, learning_rate: float = 1e-3,
                 eval_during_train: bool = False, eval_freq: int = 1000, *, width: int = 20, num_layers: int = 3,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The gPINN solver of the JAX example (the network's weights from a
    ``torch.Generator`` seeded 42); ``width`` and ``num_layers`` cut it for
    tests; ``deriv`` names a derivative-path candidate to pin."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("x",), ("u",), num_layers, width, activation="tanh", generator=torch.Generator().manual_seed(SEED),
                device=device)
    model.register_output_transform(
        lambda in_, out: {"u": in_["x"] + torch.tanh(in_["x"]) * torch.tanh(np.pi - in_["x"]) * out["u"]})
    equation = {"gPINN": GPINN1D("x", "u")}
    line = Interval(0, float(np.pi))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    pde = InteriorConstraint(equation["gPINN"].equations, {"res1": 0, "res2": 0}, line,
                             {**cfg, "batch_size": npoint_pde}, MSELoss("mean", weight={"res2": 0.01}), evenly=True,
                             name="EQ")
    validator = {
        "L2Rel": GeometryValidator({"u": lambda out: out["u"]}, {"u": u_solution}, line,
                                   {"dataset": "NamedArrayDataset", "total_size": npoint_eval,
                                    "batch_size": npoint_eval}, MSELoss("mean"), evenly=True,
                                   metric={"L2Rel_u": L2Rel()}, name="L2Rel")
    }
    return Solver(model, {pde.name: pde}, output_dir, Adam(learning_rate)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=eval_during_train, eval_freq=eval_freq,
                  validator=validator, equation=equation, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The validator's L2Rel of u against the exact solution."""
    return solver.eval()[1]["L2Rel"]["L2Rel_u.u"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 20000)
    solver.train()
    print(f"gPINN L2Rel of u: {l2rel(solver):.4f}")
