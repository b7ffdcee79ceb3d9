"""NLS + Maxwell-Bloch optical rogue wave PINN on the port (counterpart of
``examples/nlsmb_rogue_wave.py``).

The five-field NLSMB system of ``nlsmb_soliton.py`` with omega_0 = 0.25 on
(t, x) in [-0.5, 0.5]^2, supervised on 256 + 256 boundary and initial
points against the rational rogue-wave solution (:func:`rogue`), which is
localized in both t and x. An MLP 4 x 64 (tanh); the residuals on 512 x
50 interior points (``sample_iters`` cuts it), MSE "mean"; Adam 1e-3; 50
epochs of 50 steps. The report is the combined relative L2 error of the
five fields on a 32 x 64 grid (:func:`l2rel`).

Run on the GPU: ``python -m paddlescience_torch.examples.nlsmb_rogue_wave [epochs]``.
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
from paddlescience_torch.examples import nlsmb_soliton
from paddlescience_torch.geometry.geometry_1d import Interval
from paddlescience_torch.geometry.timedomain import TimeDomain, TimeXGeometry
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "rogue", "l2rel"]

FIELDS = nlsmb_soliton.FIELDS
ITERS = 50  # the example's iterations an epoch
SEED = 42


def rogue(t: np.ndarray, x: np.ndarray) -> Dict[str, np.ndarray]:
    """The rational rogue-wave solution."""
    I = 1j  # noqa: E741
    den = 1565 * x**2 - 76 * x * t + 68 * t**2 + 17
    E = ((-1565 * x**2 + (648 * I + 76 * t) * x - 68 * t**2 + 51)
         * np.exp(-I / 8 * (-12 * t + 65 * x)) / den)
    p = ((9796900 * I * x**4 + (4056480 - 951520 * I * t) * x**3
          + (-579432 * I + 874464 * I * t**2 - 196992 * t) * x**2
          + (-36448 - 41344 * I * t**3 + 176256 * t**2 - 50592 * I * t) * x
          + 884 * I + 18496 * I * t**4 + 8160 * I * t**2 - 4352 * t)
         * np.exp(-I / 8 * (-12 * t + 65 * x)) / den**2)
    eta = (4624 * t**4 - 10336 * t**3 * x + (218616 * x**2 + 6664) * t**2
           + (-237880 * x**3 + 158440 * x) * t + 2449225 * x**4
           - 136934 * x**2 - 799) / den**2
    return {"Eu": np.real(E), "Ev": np.imag(E), "pu": np.real(p), "pv": np.imag(p), "eta": eta}


def build_solver(epochs: int = 50, output_dir: Optional[str] = "./output_nlsmb_rogue", *,
                 sample_iters: Optional[int] = None, n_interior: int = 512, width: int = 64, num_layers: int = 4,
                 deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The rogue-wave solver of the JAX example (host data seeded as there,
    the network's weights from a ``torch.Generator`` seeded 42);
    ``sample_iters``, ``n_interior``, ``width``, ``num_layers`` and
    ``deriv`` as for ``examples/burgers.py``."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    model = MLP(("t", "x"), FIELDS, num_layers, width, generator=torch.Generator().manual_seed(SEED), device=device)
    equation = {"NLSMB": NLSMB(alpha_1=0.5, alpha_2=-1.0, omega_0=0.25, time=True)}
    geom = TimeXGeometry(TimeDomain(-0.5, 0.5), Interval(-0.5, 0.5))
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": ITERS if sample_iters is None else sample_iters}
    eqs = equation["NLSMB"].equations
    interior = InteriorConstraint(eqs, {k: 0 for k in eqs}, geom, {**cfg, "batch_size": n_interior},
                                  MSELoss("mean"), name="EQ")
    rng = np.random.default_rng(0)
    tb = rng.uniform(-0.5, 0.5, (256, 1)).astype(np.float32)
    xb = np.where(rng.random((256, 1)) < 0.5, -0.5, 0.5).astype(np.float32)
    t0 = np.full((256, 1), -0.5, np.float32)
    x0 = rng.uniform(-0.5, 0.5, (256, 1)).astype(np.float32)
    tt, xx = np.concatenate([tb, t0]), np.concatenate([xb, x0])
    sol = rogue(tt, xx)
    sup = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t": tt, "x": xx},
                     "label": {k: v.astype(np.float32) for k, v in sol.items()}}},
        MSELoss("mean"), {k: (lambda out, kk=k: out[kk]) for k in FIELDS}, name="ICBC")
    return Solver(model, {"EQ": interior, "ICBC": sup}, output_dir, Adam(1e-3)(model), epochs=epochs,
                  iters_per_epoch=ITERS, equation=equation, log_freq=500, seed=SEED, device=device)


def l2rel(solver: Solver) -> float:
    """The combined relative L2 error of the five fields against the rogue
    wave on the 32 x 64 grid of [-0.5, 0.5]^2."""
    return nlsmb_soliton.l2rel(solver, rogue, -0.5, 0.5)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50)
    solver.train()
    print(f"NLS-MB rogue wave combined L2Rel: {l2rel(solver):.4f}")
