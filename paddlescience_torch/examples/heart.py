"""Heart on the port: passive left-ventricle inflation, forward simulation
and inverse estimation of the myocardial stiffness E (counterpart of
``examples/heart.py``; ``heart_inverse`` is its ``problem="inverse"``).

3-D Hooke elasticity (``Hooke(E=9, nu=0.45, P=1.064, dim=3)``) on a
ventricle-like half-ellipsoid shell: displacement fixed on the base
annulus (BC_BASE), the cavity pressure P on the endocardium (BC_ENDO,
traction -P), a traction-free epicardium (BC_EPI), the three equilibrium
residuals in the wall (INTERIOR), and a synthetic radial-inflation
displacement field standing in for the reference's measurement data
(DATA, ``MSELoss("sum")``). An MLP 6 x 256 (tanh) maps (x, y, z) to (u, v,
w); Adam with ExponentialDecay (1e-3, x 0.95 every ``max(epochs // 20, 1)
* iters_per_epoch`` steps); 200 epochs of 20 steps.

The interior residuals ask for all six second derivatives of the
displacement: a 10-stream jet, which the MLP kernels take since they run
up to 16 streams; the traction boundaries need first derivatives only (4
streams), the data values only. Each geometry constraint samples
``batch_size x sample_iters`` points once (``sample_iters`` defaults to
``iters_per_epoch``, as the JAX example's dataloader configuration does)
and feeds them all every step.

Inverse: E is a learnable equation parameter starting at 2 E
(``Hooke(E=("learnable", 2 E), ...)``), fitted from the displacement data
with the network; :func:`report` gives |E_hat - E| / E.

The STL shells are written by this module (:func:`write_geometry`, the
JAX example's writer, byte for byte) under the git-ignored
``dataset/heart`` unless they are there.

Run on the GPU: ``python -m paddlescience_torch.examples.heart [forward|inverse] [epochs]``.
"""

from __future__ import annotations

import os
import random
import struct
import sys
from typing import Dict, Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, InteriorConstraint, SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.extra import Hooke
from paddlescience_torch.geometry.mesh import Mesh
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "write_geometry", "synthetic_displacement", "report", "GEOM_DIR", "PARTS"]

GEOM_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        "dataset", "heart")
PARTS = ("geo", "base", "endo", "epi")
R_ENDO = (0.7, 0.7, 1.4)
R_EPI = (1.0, 1.0, 1.8)
SEED = 42


def _tri_mesh_from_grid(P):
    """A (nu, nv, 3) parametric grid as a triangle list."""
    tris = []
    nu, nv = P.shape[:2]
    for i in range(nu - 1):
        for j in range(nv - 1):
            a, b, c, d = P[i, j], P[i + 1, j], P[i, j + 1], P[i + 1, j + 1]
            tris.append((a, b, c))
            tris.append((b, d, c))
    return tris


def _half_ellipsoid(rx, ry, rz, nu=16, nv=32, inward=False):
    """The bottom half (z <= 0) of an ellipsoid, from the equator to the
    pole."""
    th = np.linspace(np.pi / 2, np.pi, nu)  # polar angle from +z
    ph = np.linspace(0, 2 * np.pi, nv)
    T, Ph = np.meshgrid(th, ph, indexing="ij")
    P = np.stack([rx * np.sin(T) * np.cos(Ph), ry * np.sin(T) * np.sin(Ph), rz * np.cos(T)], -1)
    tris = _tri_mesh_from_grid(P)
    if inward:
        tris = [(a, c, b) for a, b, c in tris]
    return tris


def _annulus(r_in, r_out, z=0.0, nv=32, up=True):
    ph = np.linspace(0, 2 * np.pi, nv)
    ring_i = np.stack([r_in * np.cos(ph), r_in * np.sin(ph), np.full_like(ph, z)], -1)
    ring_o = np.stack([r_out * np.cos(ph), r_out * np.sin(ph), np.full_like(ph, z)], -1)
    tris = []
    for j in range(nv - 1):
        a, b = ring_i[j], ring_i[j + 1]
        c, d = ring_o[j], ring_o[j + 1]
        tris.append((a, c, b) if up else (a, b, c))
        tris.append((b, c, d) if up else (b, d, c))
    return tris


def _write_stl(path, tris):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for a, b, c in tris:
            n = np.cross(np.asarray(b) - a, np.asarray(c) - a)
            n = n / (np.linalg.norm(n) + 1e-12)
            f.write(struct.pack("<3f", *n))
            for v in (a, b, c):
                f.write(struct.pack("<3f", *np.asarray(v, np.float64)))
            f.write(struct.pack("<H", 0))
    return path


def write_geometry(geom_dir: str) -> Dict[str, str]:
    """The four STL shells (``heart_{geo,base,endo,epi}.stl``) under
    ``geom_dir``, written where any is missing; returns their paths."""
    paths = {k: os.path.join(geom_dir, f"heart_{k}.stl") for k in PARTS}
    if not all(os.path.exists(p) for p in paths.values()):
        epi = _half_ellipsoid(*R_EPI)
        endo = _half_ellipsoid(*R_ENDO, inward=True)
        base = _annulus(R_ENDO[0], R_EPI[0], up=True)
        _write_stl(paths["geo"], epi + endo + base)
        _write_stl(paths["epi"], _half_ellipsoid(*R_EPI))
        _write_stl(paths["endo"], _half_ellipsoid(*R_ENDO))
        _write_stl(paths["base"], base)
    return paths


def synthetic_displacement(xyz: np.ndarray, scale: float = 0.02) -> np.ndarray:
    """A small radial inflation field (the stand-in for the CSV data)."""
    r = np.linalg.norm(xyz, axis=1, keepdims=True) + 1e-9
    return scale * xyz / r


def build_solver(problem: str = "forward", epochs: int = 200, iters_per_epoch: int = 20,
                 output_dir: Optional[str] = "./outputs_heart", geom_dir: Optional[str] = None, e: float = 9.0,
                 nu: float = 0.45, p: float = 1.064, lr: float = 1e-3, gamma: float = 0.95, n_interior: int = 1024,
                 n_bc: int = 128, n_data: int = 512, *, sample_iters: Optional[int] = None, width: int = 256,
                 num_layers: int = 6, deriv: Optional[str] = None, device: DeviceLike = None) -> Solver:
    """The heart solver, ``problem`` "forward" or "inverse" (E learned from
    2 e). Host sampling is seeded with 42 in the JAX example's order; the
    network's weights come from a ``torch.Generator`` seeded 42.
    ``sample_iters`` sets the iterations each geometry constraint samples
    for (None: ``iters_per_epoch``); ``width``/``num_layers`` cut the
    network for tests; ``deriv`` names a derivative-path candidate to pin
    (None: none is pinned)."""
    if problem not in ("forward", "inverse"):
        raise ValueError(f"problem is 'forward' or 'inverse', got {problem!r}")
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    paths = write_geometry(GEOM_DIR if geom_dir is None else geom_dir)
    geoms = {k: Mesh(path) for k, path in paths.items()}
    model = MLP(("x", "y", "z"), ("u", "v", "w"), num_layers, width, activation="tanh",
                generator=torch.Generator().manual_seed(SEED), device=device)
    E_spec = ("learnable", e * 2.0) if problem == "inverse" else e
    equation = {"Hooke": Hooke(E=E_spec, nu=nu, P=p, dim=3)}
    eqs = equation["Hooke"].equations
    cfg = {"dataset": "IterableNamedArrayDataset",
           "iters_per_epoch": iters_per_epoch if sample_iters is None else sample_iters}
    bc_base = BoundaryConstraint({k: (lambda d, kk=k: d[kk]) for k in ("u", "v", "w")}, {"u": 0, "v": 0, "w": 0},
                                 geoms["base"], {**cfg, "batch_size": n_bc}, MSELoss("mean"), name="BC_BASE")
    bc_endo = BoundaryConstraint({"traction": eqs["traction"]}, {"traction": -p}, geoms["endo"],
                                 {**cfg, "batch_size": n_bc}, MSELoss("mean"), name="BC_ENDO")
    bc_epi = BoundaryConstraint({"traction": eqs["traction"]}, {"traction": 0}, geoms["epi"],
                                {**cfg, "batch_size": n_bc}, MSELoss("mean"), name="BC_EPI")
    interior = InteriorConstraint(eqs, {"hooke_x": 0, "hooke_y": 0, "hooke_z": 0}, geoms["geo"],
                                  {**cfg, "batch_size": n_interior}, MSELoss("mean"), name="INTERIOR")
    constraint = {c.name: c for c in (bc_base, bc_endo, bc_epi, interior)}

    samples = geoms["geo"].sample_interior(n_data)
    xyz = np.concatenate([samples["x"], samples["y"], samples["z"]], 1)
    disp = synthetic_displacement(xyz).astype("float32")
    data_input = {"x": samples["x"], "y": samples["y"], "z": samples["z"]}
    data_label = {"u": disp[:, :1], "v": disp[:, 1:2], "w": disp[:, 2:3]}
    constraint["DATA"] = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": data_input, "label": data_label},
         "batch_size": n_data, "iters_per_epoch": iters_per_epoch,
         "sampler": {"name": "BatchSampler", "shuffle": True, "drop_last": False}},
        MSELoss("sum"), name="DATA")
    validator = {"ref_u_v_w": SupervisedValidator(
        {"dataset": {"name": "NamedArrayDataset", "input": data_input, "label": data_label},
         "total_size": n_data, "batch_size": n_data,
         "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}},
        MSELoss("mean"), {k: (lambda out, kk=k: out[kk]) for k in ("u", "v", "w")},
        metric={"L2Rel": L2Rel()}, name="ref_u_v_w")}
    sched = ExponentialDecay(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=lr, gamma=gamma,
                             decay_steps=max(epochs // 20, 1) * iters_per_epoch)()
    return Solver(model, constraint, output_dir, Adam(sched)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  eval_during_train=False, validator=validator, equation=equation, seed=SEED, device=device)


def report(solver: Solver, e: float = 9.0) -> Dict[str, float]:
    """The validator's L2Rel of u, v, w against the data; for the inverse
    problem also E_hat and |E_hat - E| / E, as the JAX example reports."""
    _, group = solver.eval()
    out = {k: float(v) for k, v in group["ref_u_v_w"].items()}
    if "E" in solver.eq_params:
        e_hat = float(solver.eq_params["E"].detach())
        out.update(E_hat=e_hat, E_rel_err=abs(e_hat - e) / e)
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(problem=argv[0] if argv else "forward", epochs=int(argv[1]) if len(argv) > 1 else 200)
    solver.train()
    print(report(solver))
