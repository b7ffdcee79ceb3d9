"""NSFNet, velocity-pressure PINNs of the Navier-Stokes equations, on the
port (counterpart of ``examples/nsfnet.py``).

* net 1: Kovasznay flow (2-D steady, Re 40, analytic), MLP 4 x 50 (tanh),
  2601 random interior points, 400 supervised boundary points;
* net 3: Beltrami flow (3-D unsteady, analytic), MLP 10 x 100 (tanh) over
  (x, y, z, t) -> (u, v, w, p); 2601 interior points on the 31^3 x 11
  lattice, 59,400 supervised boundary points (the cube's six faces at 11
  times, weight alpha = 100) and 29,791 initial ones (weight beta = 100).
  The NavierStokes residual asks the MLP's jet for the value, four first
  and three second derivatives (S = 8 streams), the hand-written MLP
  kernels' path;
* nets 2 and 4 read the reference data files (``cylinder_nektar_wake.mat``,
  the JHTDB ``.npy`` files), which are not in the repository: they raise
  ``NotImplementedError`` naming them.

Training is Adam under a Piecewise ladder lr, lr/10, lr/100, lr/1000 with
boundaries at 10 %, 20 % and 60 % of the epochs (the JAX configuration
``conf/nsfnet.yaml``: 2000 epochs of 10 steps), then optionally an L-BFGS
polish from the trained parameters (:func:`lbfgs_polish`). The validator
reports the L2Rel of u, v (w) and p on 1000 random points.

Run on the GPU: ``python -m paddlescience_torch.examples.nsfnet [net] [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import InteriorConstraint, SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import NavierStokes
from paddlescience_torch.geometry.pointcloud import PointCloud
from paddlescience_torch.loss.losses import L2RelLoss, MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import Piecewise
from paddlescience_torch.optimizer.optimizer import LBFGS, Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["kovasznay", "beltrami", "data_net1", "data_net3", "build_solver", "lbfgs_polish", "l2rel"]

MISSING_DATA = {2: "cylinder_nektar_wake.mat", 4: "train_ini2.npy, train_iniv2.npy, train_xb2.npy, train_vb2.npy, "
                                                 "test43_l.npy and test43_vp.npy (JHTDB)"}


def kovasznay(x, y, lam):
    u = 1 - np.exp(lam * x) * np.cos(2 * np.pi * y)
    v = lam / (2 * np.pi) * np.exp(lam * x) * np.sin(2 * np.pi * y)
    p = 0.5 * (1 - np.exp(2 * lam * x))
    return u, v, p


def data_net1(n_train, lam, seed):
    """(interior, boundary data, None, validation data) of net 1."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-0.5, 1.0, 101)
    y = np.linspace(-0.5, 1.5, 101)
    yb1, yb2 = np.full(100, -0.5), np.full(100, 1.0)
    xb1, xb2 = np.full(100, -0.5), np.full(100, 1.5)
    y_b = np.concatenate([y[1:101], y[0:100], xb1, xb2], 0).astype("float32")
    x_b = np.concatenate([yb1, yb2, x[0:100], x[1:101]], 0).astype("float32")
    xb_train, yb_train = x_b.reshape(-1, 1), y_b.reshape(-1, 1)
    ub_train, vb_train, _ = kovasznay(xb_train, yb_train, lam)
    x_train = ((rng.random((n_train, 1)) - 1 / 3) * 3 / 2).astype("float32")
    y_train = ((rng.random((n_train, 1)) - 1 / 4) * 2).astype("float32")
    x_star = ((rng.random((1000, 1)) - 1 / 3) * 3 / 2).astype("float32")
    y_star = ((rng.random((1000, 1)) - 1 / 4) * 2).astype("float32")
    u_star, v_star, p_star = kovasznay(x_star, y_star, lam)
    return (
        {"x": x_train, "y": y_train},
        {"input": {"x": xb_train, "y": yb_train},
         "label": {"u": ub_train.astype("float32"), "v": vb_train.astype("float32")}},
        None,
        {"input": {"x": x_star, "y": y_star},
         "label": {"u": u_star.astype("float32"), "v": v_star.astype("float32"), "p": p_star.astype("float32")}},
    )


def beltrami(x, y, z, t, a=1.0, d=1.0):
    u = -a * (np.exp(a * x) * np.sin(a * y + d * z) + np.exp(a * z) * np.cos(a * x + d * y)) * np.exp(-d * d * t)
    v = -a * (np.exp(a * y) * np.sin(a * z + d * x) + np.exp(a * x) * np.cos(a * y + d * z)) * np.exp(-d * d * t)
    w = -a * (np.exp(a * z) * np.sin(a * x + d * y) + np.exp(a * y) * np.cos(a * z + d * x)) * np.exp(-d * d * t)
    p = (-0.5 * a**2 * (np.exp(2 * a * x) + np.exp(2 * a * y) + np.exp(2 * a * z)
                        + 2 * np.sin(a * x + d * y) * np.cos(a * z + d * x) * np.exp(a * (y + z))
                        + 2 * np.sin(a * y + d * z) * np.cos(a * x + d * y) * np.exp(a * (z + x))
                        + 2 * np.sin(a * z + d * x) * np.cos(a * y + d * z) * np.exp(a * (x + y)))
         * np.exp(-2 * d * d * t))
    return u, v, w, p


def data_net3(n_train, seed):
    """(interior, boundary data, initial data, validation data) of net 3:
    the six faces of a 30^2 grid each at 11 times, the 31^3 grid at t = 0,
    interior points on the 31^3 x 11 lattice."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(-1, 1, 31).astype("float32")
    t1 = np.linspace(0, 1, 11).astype("float32")
    faces = []
    for axis in range(3):
        for val in (-1.0, 1.0):
            gu, gv = np.meshgrid(grid[:30], grid[:30], indexing="ij")
            pts = np.zeros((900, 3), "float32")
            pts[:, axis] = val
            pts[:, (axis + 1) % 3] = gu.ravel()
            pts[:, (axis + 2) % 3] = gv.ravel()
            faces.append(pts)
    fpts = np.concatenate(faces, 0)
    xyzb = np.repeat(fpts, t1.shape[0], axis=0)
    tb = np.tile(t1, fpts.shape[0]).reshape(-1, 1)
    ub, vb, wb, _ = beltrami(xyzb[:, :1], xyzb[:, 1:2], xyzb[:, 2:3], tb)
    gx, gy, gz = np.meshgrid(grid, grid, grid, indexing="ij")
    x0, y0, z0 = (g.reshape(-1, 1) for g in (gx, gy, gz))
    t0 = np.zeros_like(x0)
    u0, v0, w0, _ = beltrami(x0, y0, z0, t0)
    xx = (rng.integers(0, 31, n_train) / 15 - 1).astype("float32").reshape(-1, 1)
    yy = (rng.integers(0, 31, n_train) / 15 - 1).astype("float32").reshape(-1, 1)
    zz = (rng.integers(0, 31, n_train) / 15 - 1).astype("float32").reshape(-1, 1)
    tt = (rng.integers(0, 11, n_train) / 10).astype("float32").reshape(-1, 1)
    x_s = ((rng.random((1000, 1)) - 0.5) * 2).astype("float32")
    y_s = ((rng.random((1000, 1)) - 0.5) * 2).astype("float32")
    z_s = ((rng.random((1000, 1)) - 0.5) * 2).astype("float32")
    t_s = (rng.integers(0, 11, (1000, 1)) / 10).astype("float32")
    u_s, v_s, w_s, p_s = beltrami(x_s, y_s, z_s, t_s)
    f32 = lambda a: a.astype("float32")
    return (
        {"x": xx, "y": yy, "z": zz, "t": tt},
        {"input": {"x": f32(xyzb[:, :1]), "y": f32(xyzb[:, 1:2]), "z": f32(xyzb[:, 2:3]), "t": tb},
         "label": {"u": f32(ub), "v": f32(vb), "w": f32(wb)}},
        {"input": {"x": f32(x0), "y": f32(y0), "z": f32(z0), "t": f32(t0)},
         "label": {"u": f32(u0), "v": f32(v0), "w": f32(w0)}},
        {"input": {"x": x_s, "y": y_s, "z": z_s, "t": t_s},
         "label": {"u": f32(u_s), "v": f32(v_s), "w": f32(w_s), "p": f32(p_s)}},
    )


def _sup_constraint(blob, weight, name):
    nb = len(next(iter(blob["input"].values())))
    return SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": blob["input"], "label": blob["label"]},
         "batch_size": nb, "iters_per_epoch": 1, "sampler": {"name": "BatchSampler", "shuffle": False,
                                                            "drop_last": False}},
        MSELoss("mean", weight={k: weight for k in blob["label"]}), name=name)


def build_solver(net: int = 1, epochs: int = 2000, iters_per_epoch: int = 10,
                 output_dir: Optional[str] = "./outputs_nsfnet", ntrain: int = 2601, re: float = 40.0,
                 alpha: float = 100.0, beta: float = 100.0, learning_rate: float = 1e-3, lbfgs: bool = False,
                 lbfgs_max_iter: int = 50, seed: int = 1234, *, width: Optional[int] = None,
                 num_layers: Optional[int] = None, deriv: Optional[str] = None, device: DeviceLike = None,
                 log_freq: int = 100) -> Solver:
    """The NSFNet solver of net 1 or 3 (the weights from a
    ``torch.Generator`` seeded ``seed``); ``width`` and ``num_layers``
    (default 50 x 4 for net 1, 100 x 10 for net 3) cut it for tests;
    ``lbfgs`` builds the polish solver; ``deriv`` names a derivative-path
    candidate to pin."""
    net = int(net)
    if net in MISSING_DATA:
        raise NotImplementedError(f"NSFNet net {net} reads {MISSING_DATA[net]}, which the repository does not hold")
    if net not in (1, 3):
        raise ValueError(f"net must be 1, 2, 3 or 4, got {net}")
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(seed)
    random.seed(seed)
    dim3 = net == 3
    in_keys = ("x", "y") + (("z", "t") if dim3 else ())
    out_keys = ("u", "v") + (("w",) if dim3 else ()) + ("p",)
    model = MLP(in_keys, out_keys, num_layers or (10 if dim3 else 4), width or (100 if dim3 else 50),
                activation="tanh", generator=torch.Generator().manual_seed(seed), device=device)
    if net == 1:
        lam = 0.5 * re - np.sqrt(0.25 * re**2 + 4 * np.pi**2)
        interior, sup_b, sup_0, val = data_net1(ntrain, lam, seed)
        nu = 1.0 / re
    else:
        interior, sup_b, sup_0, val = data_net3(ntrain, seed)
        nu = 1.0
    equation = {"NavierStokes": NavierStokes(nu=nu, rho=1.0, dim=3 if dim3 else 2, time=dim3)}
    geom = PointCloud(interior, in_keys)
    resid = ["continuity", "momentum_x", "momentum_y"] + (["momentum_z"] if dim3 else [])
    n_interior = len(next(iter(interior.values())))
    constraint = {"EQ": InteriorConstraint(
        equation["NavierStokes"].equations, {k: 0 for k in resid}, geom,
        {"dataset": {"name": "IterableNamedArrayDataset"}, "batch_size": n_interior,
         "iters_per_epoch": iters_per_epoch}, MSELoss("mean"), name="EQ")}
    constraint["Sup_b"] = _sup_constraint(sup_b, alpha if dim3 else 1.0, "Sup_b")
    if sup_0 is not None:
        constraint["Sup_0"] = _sup_constraint(sup_0, beta, "Sup_0")
    n_val = len(next(iter(val["input"].values())))
    validator = {"Residual": SupervisedValidator(
        {"dataset": {"name": "NamedArrayDataset", "input": val["input"], "label": val["label"]},
         "total_size": n_val, "batch_size": min(10000, n_val),
         "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}},
        L2RelLoss(), metric={"L2R": L2Rel()}, name="Residual")}
    if lbfgs:
        optimizer = LBFGS(max_iter=lbfgs_max_iter)(model)
    else:
        bounds = [int(epochs * f) for f in (0.1, 0.2, 0.6)]
        lr = Piecewise(iters_per_epoch, bounds, [learning_rate, learning_rate / 10, learning_rate / 100,
                                                 learning_rate / 1000], epochs=epochs)()
        optimizer = Adam(lr)(model)
    return Solver(model, constraint, output_dir, optimizer, epochs=epochs, iters_per_epoch=iters_per_epoch,
                  eval_during_train=False, validator=validator, equation=equation, log_freq=log_freq, seed=seed,
                  device=device)


def lbfgs_polish(trained: Solver, net: int = 1, epochs: int = 1, **kwargs) -> Solver:
    """The L-BFGS polish solver of ``net`` (``build_solver(lbfgs=True)``)
    starting from ``trained``'s parameters, as the JAX example's second
    phase."""
    polish = build_solver(net, epochs=epochs, lbfgs=True, **kwargs)
    polish.load_state_params(trained)
    return polish


def l2rel(solver: Solver):
    """The validator's L2Rel of every field."""
    return solver.eval()[1]["Residual"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(int(argv[0]) if argv else 1, epochs=int(argv[1]) if len(argv) > 1 else 2000)
    solver.train()
    print(f"nsfnet L2Rel: {l2rel(solver)}")
