"""Steady 3-D Navier-Stokes in an STL vessel on the port (counterpart of
``examples/aneurysm_flow.py``).

A bulged tube (a cylinder of radius 0.25 and length 2 with a Gaussian
"aneurysm" bulge at mid-length, capped at both ends) is written as a binary
STL (:func:`write_tube_stl`, the JAX example's writer, byte for byte) and
read as a ``Mesh``. An MLP 5 x 128 (tanh) maps (x, y, z) to (u, v, w, p);
``NavierStokes(nu=0.025, rho=1, dim=3)`` gives the interior residuals
(the momentum ones weighted by the sdf), and ``NormalDotVec`` rides in the
equation dict as in the JAX example. Constraints, MSE "sum": the
residuals on 2048 interior points, no-slip on 512 wall points (end caps
left out), a plug inflow w = 0.5 on 128 inlet points (z <= 0.05), p = 0 on
128 outlet points (z >= L - 0.05), each sampled ``batch_size x
sample_iters`` times once (``sample_iters`` defaults to the example's 10
iterations an epoch) and fed whole every step. Adam with ExponentialDecay
(1e-3, x 0.95 every ``epochs`` steps); 10 epochs of 10 steps.

The interior jet is u, its first derivatives and the three pure second
derivatives: 7 streams through the MLP kernels at width 128.
:func:`centerline_w` is the JAX example's report: the mean axial velocity
on 16 points of the axis.

Run on the GPU: ``python -m paddlescience_torch.examples.aneurysm_flow [epochs]``.
"""

from __future__ import annotations

import os
import random
import struct
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import NavierStokes, NormalDotVec
from paddlescience_torch.geometry.mesh import Mesh
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "write_tube_stl", "centerline_w", "STL_PATH", "L", "R0"]

STL_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        "dataset", "aneurysm_tube.stl")
L, R0 = 2.0, 0.25  # tube length, base radius
EPS = 0.05  # the end caps' band
ITERS = 10  # the example's iterations an epoch
SEED = 42


def write_tube_stl(path: str, n_theta: int = 24, n_z: int = 24) -> str:
    """A binary STL at ``path`` of a tube with a Gaussian bulge at
    mid-length, capped at both ends."""
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    z = np.linspace(0, L, n_z)
    radius = R0 * (1 + 0.8 * np.exp(-((z - L / 2) ** 2) / (2 * 0.15**2)))
    rings = np.stack(
        [np.stack([r * np.cos(theta), r * np.sin(theta), np.full_like(theta, zz)], 1)
         for r, zz in zip(radius, z)])  # (n_z, n_theta, 3)
    tris = []
    for i in range(n_z - 1):
        for j in range(n_theta):
            j2 = (j + 1) % n_theta
            a, b = rings[i, j], rings[i, j2]
            c, d = rings[i + 1, j], rings[i + 1, j2]
            tris.append((a, b, c))
            tris.append((b, d, c))
    for i, flip in ((0, True), (n_z - 1, False)):  # end caps (fans)
        center = np.array([0.0, 0.0, z[i]])
        for j in range(n_theta):
            j2 = (j + 1) % n_theta
            a, b = rings[i, j], rings[i, j2]
            tris.append((a, center, b) if flip else (a, b, center))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for a, b, c in tris:
            n = np.cross(b - a, c - a)
            n = n / (np.linalg.norm(n) + 1e-12)
            f.write(struct.pack("<3f", *n))
            for v in (a, b, c):
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))
    return path


def build_solver(epochs: int = 10, output_dir: Optional[str] = "./output_aneurysm", stl_path: Optional[str] = None,
                 *, sample_iters: Optional[int] = None, n_interior: int = 2048, n_wall: int = 512, n_end: int = 128,
                 width: int = 128, num_layers: int = 5, deriv: Optional[str] = None,
                 device: DeviceLike = None) -> Solver:
    """The aneurysm_flow solver; the tube is written to ``stl_path`` where
    it is absent. Host sampling is seeded with 42 in the JAX example's
    order; the network's weights come from a ``torch.Generator`` seeded 42.
    ``sample_iters`` sets the iterations each constraint samples for (None:
    the example's 10); the batch sizes, ``width`` and ``num_layers`` cut it
    for tests; ``deriv`` names a derivative-path candidate to pin (None:
    none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    stl_path = STL_PATH if stl_path is None else stl_path
    if not os.path.exists(stl_path):
        write_tube_stl(stl_path)
    geom = Mesh(stl_path)
    model = MLP(("x", "y", "z"), ("u", "v", "w", "p"), num_layers, width,
                generator=torch.Generator().manual_seed(SEED), device=device)
    equation = {"NavierStokes": NavierStokes(nu=0.025, rho=1.0, dim=3, time=False),
                "NormalDotVec": NormalDotVec(("u", "v", "w"))}
    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": ITERS if sample_iters is None else sample_iters}
    eqs = equation["NavierStokes"].equations
    momentum = ("momentum_x", "momentum_y", "momentum_z")
    interior = InteriorConstraint(eqs, {k: 0 for k in ("continuity",) + momentum}, geom,
                                  {**cfg, "batch_size": n_interior}, MSELoss("sum"),
                                  weight_dict={k: "sdf" for k in momentum}, name="EQ")
    same = {k: (lambda out, kk=k: out[kk]) for k in ("u", "v", "w")}
    wall = BoundaryConstraint(same, {"u": 0, "v": 0, "w": 0}, geom, {**cfg, "batch_size": n_wall}, MSELoss("sum"),
                              criteria=lambda x, y, z: (z > EPS) & (z < L - EPS), name="WALL")
    inlet = BoundaryConstraint(same, {"u": 0, "v": 0, "w": 0.5}, geom, {**cfg, "batch_size": n_end},
                               MSELoss("sum"), criteria=lambda x, y, z: z <= EPS, name="INLET")
    outlet = BoundaryConstraint({"p": lambda out: out["p"]}, {"p": 0}, geom, {**cfg, "batch_size": n_end},
                                MSELoss("sum"), criteria=lambda x, y, z: z >= L - EPS, name="OUTLET")
    constraint = {c.name: c for c in (interior, wall, inlet, outlet)}
    lr = ExponentialDecay(epochs=epochs, iters_per_epoch=ITERS, learning_rate=1e-3, gamma=0.95,
                          decay_steps=max(epochs, 1))()
    return Solver(model, constraint, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=ITERS,
                  equation=equation, log_freq=50, seed=SEED, device=device)


def centerline_w(solver: Solver) -> float:
    """The mean axial velocity w on 16 points of the axis, z from 0.2 to
    L - 0.2 (the JAX example's report; inlet plug 0.5)."""
    probe = {"x": np.zeros((16, 1), np.float32), "y": np.zeros((16, 1), np.float32),
             "z": np.linspace(0.2, L - 0.2, 16, dtype=np.float32).reshape(-1, 1)}
    return float(solver.predict(probe, return_numpy=True)["w"].mean())


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 10)
    solver.train()
    print(f"centerline w: mean {centerline_w(solver):.4f} (inlet plug 0.5)")
