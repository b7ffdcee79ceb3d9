"""Chip heat simulation with ChipDeepONets on the port (counterpart of
``examples/chip_heat.py``).

Operator learning of 2-D chip thermal fields, trained from physics
residuals alone: a power-map branch (the source u on the 18 x 18 interior
points), a boundary-type branch, a boundary-value branch (76 boundary
points) and a coordinate trunk (``arch/misc_nets.py``; branches 9 x 256,
trunk 6 x 128, 400 features, swish). The sources are Gaussian random
fields (:func:`grf`, numpy; 500 of each kind with the first two the
constants 1 and 0, from the JAX example's generator, so the arrays are
bitwise its own). The interior residual is d2T/dx2 + d2T/dy2 + 100 u,
the Hessians by nested jvp of the plain forward (``autodiff/ad.py``); on
each edge the boundary-type switch selects per sample Dirichlet (bc = 0),
Neumann (1), convection (2) or radiation (3), nested ``where`` as in the
JAX example. Each constraint's ``ChipHeatDataset`` pairs every point with
every source, boundary type and boundary sample (cartesian-product
indexing), batches of 1000, weight 100; Adam at 1e-3. The validators
hold one test source (alpha 4).

Run on the GPU: ``python -m paddlescience_torch.examples.chip_heat
[steps]`` (CUDA graphs of 10 steps).
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.misc_nets import ChipDeepONets
from paddlescience_torch.autodiff import ad
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.geometry import Rectangle
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "grf", "bc_residual_x", "bc_residual_y", "interior_residual"]

SEED = 42  # the JAX example's set_random_seed


def _fftind(size):
    k_ind = np.mgrid[:size, :size] - int((size + 1) / 2)
    return np.fft.fftshift(k_ind, axes=(1, 2))


def grf(rng, alpha: float = 3.0, size: int = 128, flag_normalize: bool = True) -> np.ndarray:
    """A Gaussian random field with a power-law spectrum, (1, size^2)."""
    k_idx = _fftind(size)
    amplitude = np.power(k_idx[0] ** 2 + k_idx[1] ** 2 + 1e-10, -alpha / 4.0)
    amplitude[0, 0] = 0
    noise = rng.normal(size=(size, size)) + 1j * rng.normal(size=(size, size))
    gfield = np.fft.ifft2(noise * amplitude).real
    if flag_normalize:
        gfield = (gfield - np.mean(gfield)) / np.std(gfield)
    return gfield.reshape([1, -1])


def _bc_switch(T, T_n, u_one, bc):
    rad = T_n + u_one * (T ** 2 - 1) * (T ** 2 + 1) * 5.6 / 50000
    conv = T_n + u_one * (T - 1)
    return torch.where(bc == 1, T_n - u_one, torch.where(bc == 0, T - u_one, torch.where(bc == 2, conv, rad)))


def bc_residual_x(out):
    """The boundary residual along x (the top and bottom edges)."""
    return _bc_switch(ad.unwrap(out["T"]), ad.unwrap(ad.jacobian(out["T"], out["x"])), ad.unwrap(out["u_one"]),
                      ad.unwrap(out["bc"]))


def bc_residual_y(out):
    """The boundary residual along y (the left and right edges)."""
    return _bc_switch(ad.unwrap(out["T"]), ad.unwrap(ad.jacobian(out["T"], out["y"])), ad.unwrap(out["u_one"]),
                      ad.unwrap(out["bc"]))


def interior_residual(out):
    """d2T/dx2 + d2T/dy2 + 100 u."""
    T_xx = ad.unwrap(ad.hessian(out["T"], out["x"]))
    T_yy = ad.unwrap(ad.hessian(out["T"], out["y"]))
    return T_xx + T_yy + 100 * ad.unwrap(out["u_one"])


def build_solver(epochs: int = 20000, iters_per_epoch: int = 1, output_dir: Optional[str] = "./outputs_chip_heat",
                 learning_rate: float = 1e-3, nl: int = 20, nw: int = 20, nu: int = 500, nbc: int = 500,
                 dl: float = 1.0, dw: float = 1.0, grf_alpha: float = 3.0, batch_size: int = 1000,
                 weight: float = 100.0, num_features: int = 400, branch_layers: int = 9, trunk_layers: int = 6,
                 branch_hidden: int = 256, trunk_hidden: int = 128, eval_during_train: bool = False,
                 eval_freq: int = 1000, *, device: DeviceLike = None) -> Solver:
    """The chip-heat solver of the JAX example (its data bitwise; the
    weights from a ``torch.Generator`` seeded with ``SEED``, the loaders'
    shuffled orders from the solver's own generators)."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    rng = np.random.default_rng(42)
    npoint = nl * nw
    points = Rectangle((0, 0), (dl, dw)).sample_interior(npoint, evenly=True)

    data_u = np.vstack([np.ones([1, (nl - 2) * (nw - 2)]), np.zeros([1, (nl - 2) * (nw - 2)])])
    data_bc = np.vstack([np.ones([1, npoint]), np.zeros([1, npoint])])
    data_u = np.vstack([data_u] + [grf(rng, alpha=grf_alpha, size=nl - 2) for _ in range(nu - 2)]).astype("float32")
    data_bc = np.vstack([data_bc] + [grf(rng, alpha=grf_alpha, size=nl) for _ in range(nbc - 2)]).astype("float32")
    test_u = grf(rng, alpha=4, size=nl).astype("float32")[0]

    x, y = points["x"], points["y"]
    b_idx = np.where((x == 0) | (x == dw) | (y == 0) | (y == dl))[0]
    i_idx = np.where((x != 0) & (x != dw) & (y != 0) & (y != dl))[0]
    points["u"] = np.tile(test_u[i_idx], (npoint, 1))
    points["u_one"] = test_u.T.reshape([-1, 1])
    points["bc_data"] = np.tile(test_u[b_idx], (npoint, 1))
    points["bc"] = np.zeros((npoint, 1), dtype="float32")
    top_i = np.where(x == dw)[0]
    down_i = np.where(x == 0)[0]
    left_i = np.where((y == 0) & (x != 0) & (x != dw))[0]
    right_i = np.where((y == dl) & (x != 0) & (x != dw))[0]

    def subset(idx):
        return {k: points[k][idx] for k in ("x", "y", "u", "u_one", "bc", "bc_data")}

    bctypes = np.array([[0], [1], [2], [3]], dtype="float32")

    def region_data(idx):
        return {"x": points["x"][idx], "y": points["y"][idx], "u": data_u,
                "u_one": data_bc[:, idx].T.reshape([-1, 1]), "bc": bctypes, "bc_data": data_bc[:, b_idx]}

    interior_data = {"x": points["x"][i_idx], "y": points["y"][i_idx], "u": data_u,
                     "u_one": data_u.T.reshape([-1, 1]), "bc": bctypes, "bc_data": data_bc[:, b_idx]}
    model = ChipDeepONets(
        branch_input_keys=("u",), BCtype_input_keys=("bc",), BC_input_keys=("bc_data",), trunk_input_keys=("x", "y"),
        output_keys=("T",), num_loc=(nl - 2) * (nw - 2), bctype_loc=1, BC_num_loc=len(b_idx),
        num_features=num_features, branch_num_layers=branch_layers, BC_num_layers=branch_layers,
        trunk_num_layers=trunk_layers, branch_hidden_size=branch_hidden, BC_hidden_size=branch_hidden,
        trunk_hidden_size=trunk_hidden, generator=torch.Generator().manual_seed(SEED), device=device)
    label = {"chip": np.array([0], dtype="float32")}
    wgt = {"chip": np.array([weight], dtype="float32")}
    index = ("x", "u", "bc", "bc_data")

    def sup(name, data, expr, data_type):
        return SupervisedConstraint(
            {"dataset": {"name": "ChipHeatDataset", "input": data, "label": label, "index": index,
                         "data_type": data_type, "weight": wgt},
             "batch_size": batch_size, "iters_per_epoch": iters_per_epoch,
             "sampler": {"name": "BatchSampler", "drop_last": False, "shuffle": True}},
            MSELoss("mean"), output_expr={"chip": expr}, name=name)

    constraint = {
        "top_sup": sup("top_sup", region_data(top_i), bc_residual_x, "bc_data"),
        "down_sup": sup("down_sup", region_data(down_i), bc_residual_x, "bc_data"),
        "left_sup": sup("left_sup", region_data(left_i), bc_residual_y, "bc_data"),
        "right_sup": sup("right_sup", region_data(right_i), bc_residual_y, "bc_data"),
        "interior_sup": sup("interior_sup", interior_data, interior_residual, "u"),
    }

    def val(name, data, n, expr):
        return SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": data,
                         "label": {"chip": np.zeros([n, 1], dtype="float32")}},
             "total_size": n, "batch_size": n, "sampler": {"name": "BatchSampler", "shuffle": False,
                                                          "drop_last": False}},
            MSELoss("mean"), output_expr={"chip": expr}, metric={"MSE": MSE()}, name=name)

    bval = lambda out: ad.unwrap(out["T"]) - ad.unwrap(out["u_one"])  # noqa: E731
    validator = {
        "top_mse": val("top_mse", subset(top_i), len(top_i), bval),
        "down_mse": val("down_mse", subset(down_i), len(down_i), bval),
        "left_mse": val("left_mse", subset(left_i), len(left_i), bval),
        "right_mse": val("right_mse", subset(right_i), len(right_i), bval),
        "interior_mse": val("interior_mse", subset(i_idx), len(i_idx), interior_residual),
    }
    return Solver(model, constraint, output_dir, Adam(learning_rate)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=eval_during_train, eval_freq=eval_freq,
                  validator=validator, seed=SEED, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    steps = int(argv[0]) if argv else 20000
    solver = build_solver(epochs=steps // 10, iters_per_epoch=10)  # the example's steps, one CUDA graph of 10
    solver.train(num_fused_steps=10)
    print(f"validators: {solver.eval()[1]}")
