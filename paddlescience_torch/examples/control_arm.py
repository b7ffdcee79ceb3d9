"""Control arm on the port: 3-D linear elasticity on an STL mesh, forward
analysis and inverse identification of the Lame parameters (counterpart
of ``examples/control_arm.py``).

Forward (:func:`build_forward`): a displacement network (u, v, w) and a
stress network (the six sigma_ij), two MLPs 6 x 512 with SiLU and weight
normalization in a ``ModelList``, solve the mixed form of
``LinearElasticity`` (lambda and mu from E = 1, nu = 0.3) on a ``Mesh``:
a traction (-0.0025, 0, 0) on the left bolt circle, u = v = w = 0 on the
right one, traction-free elsewhere on the surface, and the nine interior
residuals weighted by the sdf. Adam with ExponentialDecay (1e-3, x 0.95
every 15 epochs). Each constraint samples ``batch_size x sample_iters``
points once (``sample_iters`` defaults to ``iters_per_epoch``, as the JAX
example's dataloader configuration does) and feeds them all every step.

Inverse (:func:`build_inverse`): the trained networks are frozen, and two
MLPs 3 x 32 learn the fields ``lambda_`` and ``mu`` that
``LinearElasticity(lambda_="lambda_", mu="mu")`` reads by name, from the
six stress-displacement residuals; a ``GeometryValidator`` holds them
against the true values (L2Rel over 512 interior points).

The part's STL is not in the repository: when ``geom_path`` is absent a
capsule bar on the same bolt-circle layout is written there
(:func:`write_arm_stl`, the JAX example's generator), under the git-ignored
``dataset/`` by default.

Run on the GPU: ``python -m paddlescience_torch.examples.control_arm [epochs] [inverse_epochs]``.
"""

from __future__ import annotations

import os
import random
import struct
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.arch.model_list import ModelList
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import LinearElasticity
from paddlescience_torch.geometry.mesh import Mesh
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_forward", "build_inverse", "write_arm_stl", "GEOM_PATH", "STRESS_KEYS", "RESIDUAL_KEYS"]

GEOM_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "dataset", "control_arm.stl")
LEFT_C = (-1.0, 0.0)  # bolt circle in (x, y) at the left end
RIGHT_C = (1.0, 0.0)  # bolt circle in (x, z) at the right end
R_BOLT = 0.25
SEED = 2023
STRESS_KEYS = ("sigma_xx", "sigma_yy", "sigma_zz", "sigma_xy", "sigma_xz", "sigma_yz")
RESIDUAL_KEYS = ("equilibrium_x", "equilibrium_y", "equilibrium_z", "stress_disp_xx", "stress_disp_yy",
                 "stress_disp_zz", "stress_disp_xy", "stress_disp_xz", "stress_disp_yz")


def write_arm_stl(path: str, length: float = 2.4, radius: float = 0.3, n_theta: int = 24, n_z: int = 16) -> str:
    """A closed cylinder along x from -length / 2 to length / 2 (a
    simplified arm), as a binary STL at ``path``."""
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    xs = np.linspace(-length / 2, length / 2, n_z)
    rings = np.stack([np.stack([np.full_like(theta, xx), radius * np.cos(theta), radius * np.sin(theta)], 1)
                      for xx in xs])
    tris = []
    for i in range(n_z - 1):
        for j in range(n_theta):
            j2 = (j + 1) % n_theta
            a, b = rings[i, j], rings[i, j2]
            c, d = rings[i + 1, j], rings[i + 1, j2]
            tris.append((a, c, b))
            tris.append((b, c, d))
    for i, flip in ((0, False), (n_z - 1, True)):
        center = np.array([xs[i], 0.0, 0.0])
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


def _criteria():
    left = lambda x, y, z: np.sqrt((x - LEFT_C[0]) ** 2 + (y - LEFT_C[1]) ** 2) <= R_BOLT + 1e-1
    right = lambda x, y, z: np.sqrt((x - RIGHT_C[0]) ** 2 + (z - RIGHT_C[1]) ** 2) <= R_BOLT + 1e-1
    surface = lambda x, y, z: np.sqrt((x - LEFT_C[0]) ** 2 + (y - LEFT_C[1]) ** 2) > R_BOLT + 1e-1
    return left, right, surface


def load_geometry(geom_path: Optional[str] = None, native: bool = True) -> Mesh:
    """The part's mesh, the capsule bar written first where ``geom_path``
    is absent; ``native`` as for :class:`~paddlescience_torch.geometry.mesh.Mesh`."""
    geom_path = GEOM_PATH if geom_path is None else geom_path
    if not os.path.exists(geom_path):
        write_arm_stl(geom_path)
    return Mesh(geom_path, native=native)


def build_forward(epochs: int = 2000, iters_per_epoch: int = 100, output_dir: Optional[str] = "./outputs_control_arm",
                  geom_path: Optional[str] = None, nu: float = 0.3, e: float = 1.0,
                  traction: Tuple[float, float, float] = (-0.0025, 0.0, 0.0), lr: float = 1e-3,
                  gamma: float = 0.95, n_interior: int = 2048, n_bc: int = 128, *,
                  sample_iters: Optional[int] = None, width: int = 512, num_layers: int = 6,
                  deriv: Optional[str] = None, device: DeviceLike = None, native: bool = True,
                  log_freq: int = 100) -> Tuple[Solver, Mesh]:
    """The forward solver and the mesh. Host sampling is seeded with 2023
    in the JAX example's order; the networks' weights come from
    ``torch.Generator``s seeded 2023 and 2024. ``sample_iters`` sets the
    iterations each constraint samples for (None: ``iters_per_epoch``);
    ``width``/``num_layers`` cut the networks for tests; ``deriv`` names a
    derivative-path candidate to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    lambda_ = nu * e / ((1 + nu) * (1 - 2 * nu))
    mu = e / (2 * (1 + nu))
    net = lambda outs, seed: MLP(("x", "y", "z"), outs, num_layers, width, activation="silu", weight_norm=True,
                                 generator=torch.Generator().manual_seed(seed), device=device)
    model = ModelList((net(("u", "v", "w"), SEED), net(STRESS_KEYS, SEED + 1)))
    equation = {"LinearElasticity": LinearElasticity(E=None, nu=None, lambda_=lambda_, mu=mu, dim=3)}
    geom = load_geometry(geom_path, native)
    left, right, surface = _criteria()
    eqs = equation["LinearElasticity"].equations
    cfg = {"dataset": "IterableNamedArrayDataset",
           "iters_per_epoch": iters_per_epoch if sample_iters is None else sample_iters}
    tractions = {k: eqs[k] for k in ("traction_x", "traction_y", "traction_z")}
    bc_left = BoundaryConstraint(tractions, dict(zip(tractions, traction)), geom, {**cfg, "batch_size": n_bc},
                                 MSELoss("sum"), criteria=left, name="BC_LEFT")
    bc_right = BoundaryConstraint({k: (lambda d, kk=k: d[kk]) for k in ("u", "v", "w")}, {"u": 0, "v": 0, "w": 0},
                                  geom, {**cfg, "batch_size": n_bc}, MSELoss("sum"), criteria=right,
                                  name="BC_RIGHT")
    bc_surface = BoundaryConstraint(tractions, {k: 0 for k in tractions}, geom, {**cfg, "batch_size": 4 * n_bc},
                                    MSELoss("sum"), criteria=surface, name="BC_SURFACE")
    interior = InteriorConstraint(eqs, {k: 0 for k in RESIDUAL_KEYS}, geom, {**cfg, "batch_size": n_interior},
                                  MSELoss("sum"), weight_dict={k: "sdf" for k in RESIDUAL_KEYS}, name="INTERIOR")
    constraint = {c.name: c for c in (bc_left, bc_right, bc_surface, interior)}
    sched = ExponentialDecay(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=lr, gamma=gamma,
                             decay_steps=15 * iters_per_epoch)()
    solver = Solver(model, constraint, output_dir, Adam(sched)(model), epochs=epochs,
                    iters_per_epoch=iters_per_epoch, eval_during_train=False, equation=equation, log_freq=log_freq,
                    seed=SEED, device=device)
    return solver, geom


def build_inverse(fwd_solver: Solver, geom: Mesh, epochs: int = 100, iters_per_epoch: int = 100,
                  output_dir: Optional[str] = "./outputs_control_arm_inverse", nu: float = 0.3, e: float = 1.0,
                  lr: float = 1e-3, n_interior: int = 2048, *, sample_iters: Optional[int] = None,
                  log_freq: int = 100) -> Solver:
    """The inverse solver on the forward solver's trained networks, which
    are frozen here (their parameters never change again), and two new
    MLPs 3 x 32 for ``lambda_`` and ``mu`` (weights from generators seeded
    7 and 8). Its interior points continue the host's ``np.random``
    stream, as the JAX example's; ``sample_iters`` as for
    :func:`build_forward`."""
    lambda_true = nu * e / ((1 + nu) * (1 - 2 * nu))
    mu_true = e / (2 * (1 + nu))
    device = fwd_solver.device
    disp_net, stress_net = fwd_solver.models[0], fwd_solver.models[1]
    lam_net = MLP(("x", "y", "z"), ("lambda_",), 3, 32, generator=torch.Generator().manual_seed(7), device=device)
    mu_net = MLP(("x", "y", "z"), ("mu",), 3, 32, generator=torch.Generator().manual_seed(8), device=device)
    disp_net.freeze()
    stress_net.freeze()
    model = ModelList((disp_net, stress_net, lam_net, mu_net))
    equation = {"LinearElasticity": LinearElasticity(E=None, nu=None, lambda_="lambda_", mu="mu", dim=3)}
    eqs = equation["LinearElasticity"].equations
    cfg = {"dataset": "IterableNamedArrayDataset",
           "iters_per_epoch": iters_per_epoch if sample_iters is None else sample_iters}
    resid = ("stress_disp_xx", "stress_disp_yy", "stress_disp_zz", "stress_disp_xy", "stress_disp_xz",
             "stress_disp_yz")
    interior = InteriorConstraint(eqs, {k: 0 for k in resid}, geom, {**cfg, "batch_size": n_interior},
                                  MSELoss("sum"), name="INTERIOR")
    validator = {"elasticity": GeometryValidator(
        {"lambda_": lambda out: out["lambda_"], "mu": lambda out: out["mu"]},
        {"lambda_": lambda_true, "mu": mu_true}, geom,
        {"dataset": "NamedArrayDataset", "total_size": 512, "batch_size": 512}, MSELoss("mean"),
        metric={"L2Rel": L2Rel()}, name="elasticity")}
    return Solver(model, {"INTERIOR": interior}, output_dir, Adam(lr)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=False, validator=validator, equation=equation,
                  log_freq=log_freq, seed=SEED, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    fwd, mesh = build_forward(epochs=int(argv[0]) if argv else 2000)
    fwd.train()
    inv = build_inverse(fwd, mesh, epochs=int(argv[1]) if len(argv) > 1 else 100)
    inv.train()
    print(f"inverse: {inv.eval()[1]}")
