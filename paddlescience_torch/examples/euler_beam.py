"""Euler beam 1-D biharmonic PINN on the port (counterpart of
``examples/euler_beam.py``):

  u'''' + 1 = 0 on (0, 1),  u(0) = u'(0) = 0,  u''(1) = u'''(1) = 0,

with the analytic solution u = -x^4/24 + x^3/6 - x^2/4.

MLP 3 x 20 (tanh) on ``Interval(0, 1)``; the ``Biharmonic(dim=1, q=-1,
D=1)`` residual on ``100 * iters_per_epoch`` Hammersley interior points
(MSE), and the four boundary terms on ``4 * iters_per_epoch`` evenly
spaced boundary points, [0, 0, 1, 1] at one iteration per epoch, taken
row by row as the JAX example takes them: u at row 0, u' at row 1, u'' at
row 2, u''' at row 3 (MSE summed); Adam at 1e-3. Both datasets feed
their whole sample every step. The validator holds u against the analytic
solution on 100 evenly spaced points (L2Rel).

Derivatives: u' and u'' come from the model's jet forward (on
``jet_pallas*``, the MLP jet kernels); u''' and the fourth-order residual
from nested jvp of the plain forward (``autodiff/ad.py``).

Run on the GPU: ``python -m paddlescience_torch.examples.euler_beam
[epochs] [iters_per_epoch]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.autodiff.ad import hessian, jacobian
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import Biharmonic
from paddlescience_torch.geometry import Interval
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "u_solution_func", "train", "evaluate"]


def u_solution_func(out):
    x = out["x"]
    return -(x**4) / 24 + x**3 / 6 - x**2 / 4


def build_solver(epochs: int = 100, iters_per_epoch: int = 10, output_dir: Optional[str] = "./output_euler_beam",
                 *, deriv: Optional[str] = None, device: DeviceLike = None, seed: int = 42,
                 log_freq: int = 100, eval_during_train: bool = False) -> Solver:
    """The euler_beam solver of the JAX example (its sampling seeded with
    ``seed`` as the example seeds it); ``deriv`` names a derivative-path
    candidate to pin (None: none is pinned, as in the JAX example)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(seed)
    random.seed(seed)
    model = MLP(("x",), ("u",), 3, 20, generator=torch.Generator().manual_seed(seed), device=device)
    interval = Interval(0, 1)
    equation = {"biharmonic": Biharmonic(dim=1, q=-1.0, D=1.0)}

    dataloader_cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": iters_per_epoch}
    pde = InteriorConstraint(equation["biharmonic"].equations, {"biharmonic": 0}, interval,
                             {**dataloader_cfg, "batch_size": 100}, MSELoss(), random="Hammersley", name="EQ")
    bc = BoundaryConstraint(
        {
            "u0": lambda d: d["u"][0:1],
            "u__x": lambda d: jacobian(d["u"], d["x"])[1:2],
            "u__x__x": lambda d: hessian(d["u"], d["x"])[2:3],
            "u__x__x__x": lambda d: jacobian(hessian(d["u"], d["x"]), d["x"])[3:4],
        },
        {"u0": 0, "u__x": 0, "u__x__x": 0, "u__x__x__x": 0},
        interval,
        {**dataloader_cfg, "batch_size": 4},
        MSELoss("sum"),
        evenly=True,
        name="BC",
    )
    constraint = {c.name: c for c in (pde, bc)}
    validator = {
        "L2Rel_Metric": GeometryValidator(
            {"u": lambda out: out["u"]},
            {"u": u_solution_func},
            interval,
            {"dataset": "IterableNamedArrayDataset", "total_size": 100},
            MSELoss(),
            evenly=True,
            metric={"L2Rel": L2Rel()},
            name="L2Rel_Metric",
        )
    }
    return Solver(model, constraint, output_dir, Adam(1e-3)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  validator=validator, equation=equation, log_freq=log_freq, eval_during_train=eval_during_train,
                  seed=seed, device=device)


def train(**kwargs) -> float:
    """Train a :func:`build_solver` solver (``kwargs`` are its arguments),
    evaluate it and return the L2Rel of u against the analytic solution."""
    solver = build_solver(**kwargs)
    solver.train()
    metric, _ = solver.eval()
    print(f"final L2Rel.u = {metric:.4e}")
    return metric


def evaluate(pretrained_model_path: Optional[str] = None, **kwargs) -> float:
    """L2Rel of a :func:`build_solver` model against the analytic solution,
    with the parameters of the checkpoint at ``pretrained_model_path`` if
    given."""
    solver = build_solver(**kwargs)
    if pretrained_model_path:
        solver.load_pretrain(pretrained_model_path)
    metric, _ = solver.eval()
    print(f"eval L2Rel.u = {metric:.4e}")
    return metric


if __name__ == "__main__":
    argv = sys.argv[1:]
    train(epochs=int(argv[0]) if argv else 100, iters_per_epoch=int(argv[1]) if len(argv) > 1 else 10)
