"""PhyGeoNet, the physics-informed geometry-adaptive CNN, on the port
(counterpart of ``examples/phygeonet.py`` and, through
:func:`build_solver_bc`, ``examples/phygeonet_bc.py``).

A USCNN (hidden (16, 32, 16), 5x5 convolutions) maps a 19 x 84
body-fitted grid to the temperature field; the loss is the mean squared
Laplace residual, from 4th-order finite differences in the reference
coordinates (xi, eta) mapped through the mesh's metric terms
(:func:`dfdx`, :func:`dfdy`), after the Dirichlet frame is written into
the output (index assignment on a copy, where JAX sets ``.at[]``). Both
meshes are the JAX example's analytic ones with exact metric terms:

* :func:`build_solver`: the quarter annulus (T = 0 on the outer edge, 1
  on the other three, the two outer corners averaged), the coordinates as
  the input; :func:`evaluate_field` against a Jacobi solve of Laplace's
  equation in polar coordinates (:func:`jacobi_reference`);
* :func:`build_solver_bc`: the full annulus (inner edge T = para, outer
  0, periodic in theta), the boundary values 1..7 broadcast over the grid
  as the input, a batch of all seven; :func:`evaluate_field_bc` against
  the analytic profile para ln(r_out / r) / ln(r_out / r_in).

Adam at 1e-3, one step an epoch (the JAX examples' 1500 epochs). Run on
the GPU: ``python -m paddlescience_torch.examples.phygeonet [epochs
[bc]]``.
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddlescience_torch.arch.misc_nets import USCNN
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "build_solver_bc", "evaluate_field", "evaluate_field_bc", "dfdx", "dfdy", "load_data",
           "jacobi_reference", "annulus_mesh", "full_annulus_mesh"]

SEED = 42  # the JAX example's set_random_seed

H = 0.01
PAD = 1
METRIC_KEYS = ("coords", "jinvs", "dxdxis", "dydxis", "dxdetas", "dydetas")


def _d_xi(f, h):
    internal = (-f[..., 4:] + 8 * f[..., 3:-1] - 8 * f[..., 1:-3] + f[..., 0:-4]) / 12 / h
    left = (-11 * f[..., 0:-3] + 18 * f[..., 1:-2] - 9 * f[..., 2:-1] + 2 * f[..., 3:]) / 6 / h
    right = (11 * f[..., 3:] - 18 * f[..., 2:-1] + 9 * f[..., 1:-2] - 2 * f[..., 0:-3]) / 6 / h
    return torch.cat([left[..., 0:2], internal, right[..., -2:]], -1)


def _d_eta(f, h):
    internal = (-f[..., 4:, :] + 8 * f[..., 3:-1, :] - 8 * f[..., 1:-3, :] + f[..., 0:-4, :]) / 12 / h
    low = (-11 * f[..., 0:-3, :] + 18 * f[..., 1:-2, :] - 9 * f[..., 2:-1, :] + 2 * f[..., 3:, :]) / 6 / h
    up = (11 * f[..., 3:, :] - 18 * f[..., 2:-1, :] + 9 * f[..., 1:-2, :] - 2 * f[..., 0:-3, :]) / 6 / h
    return torch.cat([low[..., 0:2, :], internal, up[..., -2:, :]], -2)


def dfdx(f, dydeta, dydxi, jinv, h=H):
    """d/dx on the curvilinear grid."""
    return jinv * (_d_xi(f, h) * dydeta - _d_eta(f, h) * dydxi)


def dfdy(f, dxdxi, dxdeta, jinv, h=H):
    """d/dy on the curvilinear grid."""
    return jinv * (_d_eta(f, h) * dxdxi - _d_xi(f, h) * dxdeta)


def _laplacian_residual(v, jinv, dxdxi, dydxi, dxdeta, dydeta):
    """mean((d2v/dx2 + d2v/dy2)^2) as (1, 1)."""
    d2x = dfdx(dfdx(v, dydeta, dydxi, jinv), dydeta, dydxi, jinv)
    d2y = dfdy(dfdy(v, dxdxi, dxdeta, jinv), dxdxi, dxdeta, jinv)
    return torch.mean((d2x + d2y) ** 2)[None, None]


def _mesh(theta, r, dth_dxi, dr_deta) -> Dict[str, np.ndarray]:
    R, TH = np.meshgrid(r, theta, indexing="ij")  # (ny, nx)
    x, y = R * np.cos(TH), R * np.sin(TH)
    dxdxi = -R * np.sin(TH) * dth_dxi
    dydxi = R * np.cos(TH) * dth_dxi
    dxdeta = np.cos(TH) * dr_deta
    dydeta = np.sin(TH) * dr_deta
    jinv = 1.0 / (dxdxi * dydeta - dxdeta * dydxi)
    f32 = lambda a: a[None, None].astype("float32")  # noqa: E731  (1, 1, ny, nx)
    coords = np.concatenate([x[None, None], y[None, None]], 1).astype("float32")
    return dict(coords=coords, jinvs=f32(jinv), dxdxis=f32(dxdxi), dydxis=f32(dydxi), dxdetas=f32(dxdeta),
                dydetas=f32(dydeta))


def annulus_mesh(ny: int = 19, nx: int = 84, r_in: float = 1.0, r_out: float = 2.0) -> Dict[str, np.ndarray]:
    """The quarter annulus: xi the angle, eta the radius."""
    xi, eta = np.arange(nx) * H, np.arange(ny) * H
    th0, th1 = 0.0, np.pi / 2
    theta = th0 + (th1 - th0) * xi / xi[-1]
    r = r_in + (r_out - r_in) * eta / eta[-1]
    return _mesh(theta, r, (th1 - th0) / xi[-1], (r_out - r_in) / eta[-1])


def full_annulus_mesh(ny: int = 19, nx: int = 84, r_in: float = 1.0, r_out: float = 2.0) -> Dict[str, np.ndarray]:
    """The full annulus: xi the angle (periodic, the endpoint left out),
    eta the radius."""
    xi, eta = np.arange(nx) * H, np.arange(ny) * H
    theta = 2 * np.pi * xi / (xi[-1] + (xi[1] - xi[0]))
    r = r_in + (r_out - r_in) * eta / eta[-1]
    return _mesh(theta, r, (theta[1] - theta[0]) / (xi[1] - xi[0]), (r_out - r_in) / eta[-1])


def load_data(data_dir: Optional[str]) -> Dict[str, np.ndarray]:
    """``heat_equation.npz`` when it exists, else the analytic quarter annulus."""
    if data_dir and osp.exists(data_dir):
        data = np.load(data_dir)
        return {k: data[k] for k in METRIC_KEYS}
    print(f"[phygeonet] {data_dir!r} absent -> analytic quarter-annulus mesh")
    return annulus_mesh()


def _apply_bc(v: torch.Tensor) -> torch.Tensor:
    """The Dirichlet frame: the outer eta edge 0, the other three edges 1,
    the two corners of the first row averaged."""
    v = v.clone()
    v[:, 0, -PAD:, PAD:-PAD] = 0.0
    v[:, 0, :PAD, PAD:-PAD] = 1.0
    v[:, 0, PAD:-PAD, -PAD:] = 1.0
    v[:, 0, PAD:-PAD, 0:PAD] = 1.0
    v[:, 0, 0, 0] = 0.5 * (v[:, 0, 0, 1] + v[:, 0, 1, 0])
    v[:, 0, 0, -1] = 0.5 * (v[:, 0, 0, -2] + v[:, 0, 1, -1])
    return v


def jacobi_reference(data: Dict[str, np.ndarray], iters: int = 20000, r_in: float = 1.0,
                     r_out: float = 2.0) -> np.ndarray:
    """Laplace in polar coordinates (u_rr + u_r / r + u_tt / r^2 = 0) on
    the same (r, theta) lattice with the example's boundary values,
    Jacobi-iterated (the JAX example's reference, in numpy)."""
    ny, nx = data["coords"].shape[-2:]
    r = np.linspace(r_in, r_out, ny)
    th = np.linspace(0, np.pi / 2, nx)
    dr, dth = r[1] - r[0], th[1] - th[0]
    u = np.zeros((ny, nx))
    u[0, :] = 1.0
    u[-1, :] = 0.0
    u[:, 0] = 1.0
    u[:, -1] = 1.0
    u[-1, 0] = 0.5
    u[-1, -1] = 0.5
    R = r[1:-1][:, None]
    a = 1 / dr ** 2 + 1 / (2 * R * dr)
    b = 1 / dr ** 2 - 1 / (2 * R * dr)
    c = 1 / (R ** 2 * dth ** 2)
    diag = 2 / dr ** 2 + 2 * c
    for _ in range(iters):
        u[1:-1, 1:-1] = (a * u[2:, 1:-1] + b * u[:-2, 1:-1] + c * (u[1:-1, 2:] + u[1:-1, :-2])) / diag
    return u


def _residual_constraint(inputs: Dict[str, np.ndarray], batch_size: int) -> SupervisedConstraint:
    return SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": inputs}, "batch_size": batch_size, "iters_per_epoch": 1,
         "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}},
        FunctionalLoss(lambda out, label, weight: {"residual": out["residual"].sum()}),
        {"residual": lambda out: out["residual"], "output_v": lambda out: out["output_v"]}, name="residual")


def build_solver(epochs: int = 1500, output_dir: Optional[str] = "./outputs_phygeonet", learning_rate: float = 1e-3,
                 data_dir: Optional[str] = "./dataset/phygeonet/heat_equation.npz",
                 hidden: Sequence[int] = (16, 32, 16), *, device: DeviceLike = None):
    """The quarter-annulus solver of the JAX example and its mesh data."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    data = load_data(data_dir)
    ny, nx = data["coords"].shape[-2:]
    model = USCNN(("coords",), ("output_v",), hidden_size=list(hidden), h=H, nx=nx, ny=ny, nvar_in=2, nvar_out=1,
                  pad_singleside=PAD, generator=torch.Generator().manual_seed(SEED), device=device)

    metric = {k: torch.as_tensor(data[k], device=device) for k in METRIC_KEYS[1:]}

    def transform_out(in_, out):
        v = _apply_bc(out["output_v"])
        # the metric terms of the batch where the model is handed them, else the mesh's (as the JAX example)
        m = {k: in_[k] if k in in_ else t.to(v.device) for k, t in metric.items()}
        res = _laplacian_residual(v, m["jinvs"], m["dxdxis"], m["dydxis"], m["dxdetas"], m["dydetas"])
        return {"residual": res, "output_v": v}

    model.register_output_transform(transform_out)
    sup = _residual_constraint({k: data[k] for k in METRIC_KEYS}, 1)
    solver = Solver(model, {"residual": sup}, output_dir, Adam(learning_rate)(model), epochs=epochs,
                    iters_per_epoch=1, eval_during_train=False, seed=SEED, device=device)
    return solver, data


def evaluate_field(solver: Solver, data: Dict[str, np.ndarray], ref: Optional[np.ndarray] = None) -> float:
    """The relative L2 of the predicted field against the Jacobi reference."""
    out = solver.predict({k: data[k] for k in METRIC_KEYS}, batch_size=1, return_numpy=True)
    v = out["output_v"][0, 0]
    if ref is None:
        ref = jacobi_reference(data)
    ev = float(np.sqrt(np.mean((ref - v) ** 2) / np.mean(ref ** 2)))
    print(f"phygeonet ev (rel L2 vs discrete reference) = {ev:.4f}")
    return ev


def build_solver_bc(epochs: int = 1500, output_dir: Optional[str] = "./outputs_phygeonet_bc",
                    learning_rate: float = 1e-3, paras: Sequence[float] = (1, 2, 3, 4, 5, 6, 7),
                    hidden: Sequence[int] = (16, 32, 16), *, device: DeviceLike = None):
    """The parametric-boundary solver of the JAX example and its (inputs,
    mesh)."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    data = full_annulus_mesh()
    ny, nx = data["coords"].shape[-2:]
    paras = np.asarray(paras, "float32")
    para_imgs = np.ones((len(paras), 1, ny, nx), "float32") * paras[:, None, None, None]
    model = USCNN(("para",), ("output_v",), hidden_size=list(hidden), h=H, nx=nx, ny=ny, nvar_in=1, nvar_out=1,
                  pad_singleside=PAD, generator=torch.Generator().manual_seed(SEED), device=device)
    metric = {k: torch.as_tensor(data[k], device=device) for k in METRIC_KEYS[1:]}

    def transform_out(in_, out):
        v = out["output_v"].clone()
        para = in_["para"][:, :, 0:1, 0:1]
        v[:, :, :PAD, :] = para.expand(-1, -1, PAD, v.shape[-1])  # inner edge: para; outer: 0
        v[:, :, -PAD:, :] = 0.0
        v[:, :, :, 0:PAD] = v[:, :, :, -2 * PAD: -PAD]  # periodic in theta: the frame columns wrap
        v[:, :, :, -PAD:] = v[:, :, :, PAD: 2 * PAD]
        m = {k: t.to(v.device) for k, t in metric.items()}  # a no-op on the model's own device
        res = _laplacian_residual(v, m["jinvs"], m["dxdxis"], m["dydxis"], m["dxdetas"], m["dydetas"])
        return {"residual": res, "output_v": v}

    model.register_output_transform(transform_out)
    sup = _residual_constraint({"para": para_imgs}, len(paras))
    solver = Solver(model, {"residual": sup}, output_dir, Adam(learning_rate)(model), epochs=epochs,
                    iters_per_epoch=1, eval_during_train=False, seed=SEED, device=device)
    return solver, (para_imgs, data)


def evaluate_field_bc(solver: Solver, aux, r_in: float = 1.0, r_out: float = 2.0) -> float:
    """The relative L2 against T(r; para) = para ln(r_out / r) / ln(r_out / r_in)."""
    para_imgs, _ = aux
    v = solver.predict({"para": para_imgs}, batch_size=len(para_imgs), return_numpy=True)["output_v"][:, 0]
    r = np.linspace(r_in, r_out, v.shape[1])
    truth = para_imgs[:, 0, 0, 0][:, None] * np.log(r_out / r)[None, :] / np.log(r_out / r_in)
    truth = np.repeat(truth[:, :, None], v.shape[2], axis=2)
    ev = float(np.sqrt(np.mean((truth - v) ** 2) / np.mean(truth ** 2)))
    print(f"phygeonet_bc ev (rel L2 vs analytic log profile) = {ev:.4f}")
    return ev


if __name__ == "__main__":
    argv = sys.argv[1:]
    epochs = int(argv[0]) if argv else 1500
    if argv[1:2] == ["bc"]:
        solver, aux = build_solver_bc(epochs=epochs)
        solver.train()
        evaluate_field_bc(solver, aux)
    else:
        solver, data = build_solver(epochs=epochs)
        solver.train()
        evaluate_field(solver, data)
