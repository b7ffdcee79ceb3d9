"""NLS + Maxwell-Bloch optical soliton PINN on the port (counterpart of
``examples/nlsmb_soliton.py``).

Five coupled fields (Eu, Ev, pu, pv, eta) over (t, x) in [-1, 1]^2 with
``NLSMB(alpha_1=0.5, alpha_2=-1, omega_0=-1, time=True)``; initial and
boundary data (256 + 256 points) from the exact one-soliton solution
(:func:`soliton`). An MLP 4 x 64 (tanh); the five residuals on 512 x 50
interior points (sampled once and fed whole every step; ``sample_iters``
cuts it), MSE "mean"; Adam 1e-3; 10 epochs of 50 steps. :func:`l2rel` is
the JAX example's report: the combined relative L2 error of the five
fields on a 32 x 64 grid.

Run on the GPU: ``python -m paddlescience_torch.examples.nlsmb_soliton [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Dict, Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import InteriorConstraint, SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.extra import NLSMB
from paddlescience_torch.geometry.geometry_1d import Interval
from paddlescience_torch.geometry.timedomain import TimeDomain, TimeXGeometry
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "soliton", "l2rel", "FIELDS"]

FIELDS = ("Eu", "Ev", "pu", "pv", "eta")
ITERS = 50  # the example's iterations an epoch
SEED = 42


def soliton(t: np.ndarray, x: np.ndarray) -> Dict[str, np.ndarray]:
    """The one-soliton closed form (alpha_1 = 0.5, alpha_2 = -1, omega_0 =
    -1)."""
    ch = np.cosh(2 * t + 6 * x)
    Eu = 2 * np.cos(2 * t) / ch
    Ev = -2 * np.sin(2 * t) / ch
    pu = (np.exp(-2 * t - 6 * x) - np.exp(2 * t + 6 * x)) * np.cos(2 * t) / ch**2
    pv = -(np.exp(-2 * t - 6 * x) - np.exp(2 * t + 6 * x)) * np.sin(2 * t) / ch**2
    eta = (ch**2 - 2) / ch**2
    return {"Eu": Eu, "Ev": Ev, "pu": pu, "pv": pv, "eta": eta}


def build_solver(epochs: int = 10, output_dir: Optional[str] = "./output_nlsmb", *,
                 sample_iters: Optional[int] = None, n_interior: int = 512, width: int = 64, num_layers: int = 4,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The soliton solver of the JAX example (host data seeded as there,
    the network's weights from a ``torch.Generator`` seeded 42);
    ``sample_iters``, ``n_interior``, ``width``, ``num_layers`` and
    ``deriv`` as for ``examples/burgers.py``."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("t", "x"), FIELDS, num_layers, width, generator=torch.Generator().manual_seed(SEED), device=device)
    equation = {"NLSMB": NLSMB(alpha_1=0.5, alpha_2=-1.0, omega_0=-1.0, time=True)}
    geom = TimeXGeometry(TimeDomain(-1.0, 1.0), Interval(-1.0, 1.0))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": ITERS if sample_iters is None else sample_iters}
    eqs = equation["NLSMB"].equations
    interior = InteriorConstraint(eqs, {k: 0 for k in eqs}, geom, {**cfg, "batch_size": n_interior},
                                  MSELoss("mean"), name="EQ")
    rng = np.random.default_rng(0)
    tb = rng.uniform(-1, 1, (256, 1)).astype(np.float32)
    xb = np.where(rng.random((256, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    t0 = np.full((256, 1), -1.0, np.float32)
    x0 = rng.uniform(-1, 1, (256, 1)).astype(np.float32)
    tt, xx = np.concatenate([tb, t0]), np.concatenate([xb, x0])
    sol = soliton(tt, xx)
    sup = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t": tt, "x": xx},
                     "label": {k: v.astype(np.float32) for k, v in sol.items()}}},
        MSELoss("mean"), {k: (lambda out, kk=k: out[kk]) for k in FIELDS}, name="ICBC")
    return Solver(model, {"EQ": interior, "ICBC": sup}, output_dir, Adam(1e-3)(model), epochs=epochs,
                  iters_per_epoch=ITERS, equation=equation, log_freq=100, seed=SEED, device=device)


def l2rel(solver: Solver, truth_fn=soliton, lo: float = -1.0, hi: float = 1.0) -> float:
    """The combined relative L2 error of the five fields against
    ``truth_fn`` on the 32 (t) x 64 (x) grid of [lo, hi]^2."""
    t, x = np.meshgrid(np.linspace(lo, hi, 32), np.linspace(lo, hi, 64), indexing="ij")
    pred = solver.predict({"t": t.reshape(-1, 1).astype(np.float32), "x": x.reshape(-1, 1).astype(np.float32)},
                          return_numpy=True)
    truth = truth_fn(t.reshape(-1, 1), x.reshape(-1, 1))
    return float(np.sqrt(sum(np.sum((pred[k] - truth[k]) ** 2) for k in truth)
                         / sum(np.sum(truth[k] ** 2) for k in truth)))


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 10)
    solver.train()
    print(f"NLS-MB soliton combined L2Rel: {l2rel(solver):.4f}")
