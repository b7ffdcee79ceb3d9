"""SPINN for the 3-D Helmholtz equation on the port (counterpart of
``examples/spinn_helmholtz3d.py``).

u_xx + u_yy + u_zz + k^2 u = q on (-1, 1)^3 with the manufactured solution
u* = sin(a1 pi x) sin(a2 pi y) sin(a3 pi z) (a = 4, 4, 3; k = 1). A SPINN
(r = 32, per-axis ModifiedMLP branch nets 4 x 64, tanh) evaluates the
field on a product grid of ``nc`` points per axis, resampled on the
device every step from the solver's generator (``nc`` = 32: 32^3
collocation points for 3 x 32 branch-net rows a forward); the Dirichlet
condition is hard, the output multiplied by sin(pi x) sin(pi y) sin(pi z).
The Laplacian comes from the tape's grid stack: one nested jvp per axis.
Adam with ExponentialDecay (1e-3, gamma 0.9 every 1000 steps), 50 epochs of
1000 steps (the JAX configuration ``conf/spinn_helmholtz3d.yaml``); the
validator reports the L2Rel of u on the ``nc_test``^3 grid.

Run on the GPU: ``python -m paddlescience_torch.examples.spinn_helmholtz3d [epochs]``.
"""

from __future__ import annotations

import math
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.spinn import SPINN
from paddlescience_torch.autodiff import ad
from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.data.dataset.array_dataset import DeviceSampledDataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "u_star", "l2rel", "A1", "A2", "A3", "K"]

A1, A2, A3 = 4.0, 4.0, 3.0
K = 1.0
SEED = 42
LAM = K**2 - ((A1 * math.pi) ** 2 + (A2 * math.pi) ** 2 + (A3 * math.pi) ** 2)


def u_star(x, y, z, lib=torch):
    """The manufactured solution on the product grid of 1-D x, y, z."""
    return (lib.sin(A1 * math.pi * x[:, None, None]) * lib.sin(A2 * math.pi * y[None, :, None])
            * lib.sin(A3 * math.pi * z[None, None, :]))


def hard_bc(inp, out):
    """u <- u sin(pi x) sin(pi y) sin(pi z), 0 on the cube's faces."""
    env = (torch.sin(math.pi * inp["x"][:, None, None, :]) * torch.sin(math.pi * inp["y"][None, :, None, :])
           * torch.sin(math.pi * inp["z"][None, None, :, :]))
    return {"u": out["u"] * env}


def helmholtz(out):
    u = out["u"]
    return ad.unwrap(ad.hessian(u, out["x"]) + ad.hessian(u, out["y"]) + ad.hessian(u, out["z"]) + (K**2) * u)


def build_solver(epochs: int = 50, iters_per_epoch: int = 1000, nc: int = 32, hidden_size: int = 64,
                 nc_test: int = 100, output_dir: Optional[str] = "./output_spinn_helmholtz3d", *, r: int = 32,
                 num_layers: int = 4, device: DeviceLike = None, log_freq: int = 100) -> Solver:
    """The SPINN solver of the JAX example (the branch nets' weights from a
    ``torch.Generator`` seeded 42); ``nc`` is the JAX configuration's
    ``n_axis``."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    model = SPINN(("x", "y", "z"), ("u",), r=r, num_layers=num_layers, hidden_size=hidden_size,
                  generator=torch.Generator().manual_seed(SEED), device=device)
    model.register_output_transform(hard_bc)

    def sample_fn(generator: torch.Generator):
        coords = {k: torch.rand((nc, 1), generator=generator, device=generator.device) * 2.0 - 1.0 for k in "xyz"}
        q = LAM * u_star(coords["x"][:, 0], coords["y"][:, 0], coords["z"][:, 0])[..., None]
        return coords, {"helmholtz": q}, {}

    pde = Constraint(DeviceSampledDataset(sample_fn), None, MSELoss("mean"), "EQ")
    pde.output_expr = {"helmholtz": helmholtz}
    lr = ExponentialDecay(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3, gamma=0.9,
                          decay_steps=1000)()
    grid = np.linspace(-1, 1, nc_test, dtype=np.float32).reshape(-1, 1)
    u_ref = u_star(grid[:, 0], grid[:, 0], grid[:, 0], np)[..., None].astype(np.float32)
    validator = {"u_val": SupervisedValidator(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"x": grid, "y": grid, "z": grid},
                     "label": {"u": u_ref}}},
        MSELoss(), {"u": lambda out: out["u"]}, metric={"L2Rel": L2Rel()}, name="u_val")}
    return Solver(model, {"EQ": pde}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  validator=validator, log_freq=log_freq, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The validator's L2Rel of u on the test grid."""
    return solver.eval()[1]["u_val"]["L2Rel.u"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50)
    solver.train()
    print(f"spinn_helmholtz3d L2Rel of u: {l2rel(solver):.4f}")
