"""BubbleNet, semi-supervised two-phase bubble flow, on the port
(counterpart of ``examples/bubble.py``).

Three MLPs 9 x 30 (tanh) over (t, x, y) in a ``ModelList``: the
psi-net, whose output transform turns the stream function into the
velocity (u = psi_y, v = -psi_x: the transform calls ``jacobian``, so the
raw net runs on the tape and u, v form a derived stack), the p-net and the
phil-net (level set), trained on 75% of the field's points (labels of u,
v, p, phil; batches of 2419 from a shuffled loader, the short last batch
kept) plus the pressure Poisson residual p_xx + p_yy = 0 on every
training point (a ``PointCloud``); MSE "mean"; Adam 1e-3; 10000 epochs of
1 step. ``data_path`` names the example's ``bubble.mat`` (X (N, 2), t (T,
1), u, v, p, phil (N, T)); when it is absent the JAX example's synthetic
rising-bubble field on the same layout is used (30 x 10 points, 21 time
steps). The validator reports the MSE of u, v, p, phil on all points.

Run on the GPU: ``python -m paddlescience_torch.examples.bubble [epochs]``.
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.arch.model_list import ModelList
from paddlescience_torch.autodiff import ad
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import InteriorConstraint, SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.geometry.pointcloud import PointCloud
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "synthetic_bubble", "load_data", "field_mse"]

SEED = 42
FIELDS = ("X", "t", "u", "v", "p", "phil")


def synthetic_bubble(nx: int = 30, ny: int = 10, nt: int = 21):
    """A rising-bubble-like analytic field on [0, 15] x [0, 5], t in [1, nt]
    (the JAX example's ``_synthetic_bubble``)."""
    x = np.linspace(0, 15, nx)
    y = np.linspace(0, 5, ny)
    gx, gy = np.meshgrid(x, y, indexing="ij")
    X = np.stack([gx.ravel(), gy.ravel()], 1)
    t = np.arange(1, nt + 1, dtype=np.float64).reshape(-1, 1)
    N, T = X.shape[0], nt
    xc, r = 7.5, 1.0
    u, v, p, phil = (np.zeros((N, T)) for _ in range(4))
    for k in range(T):
        yc = 0.5 + 4.0 * (k / max(T - 1, 1))
        d2 = (X[:, 0] - xc) ** 2 + (X[:, 1] - yc) ** 2
        phil[:, k] = 1.0 / (1.0 + np.exp((d2 - r**2) * 4.0))
        u[:, k] = -0.3 * (X[:, 1] - yc) * np.exp(-d2 / (2 * r**2))
        v[:, k] = 0.3 * (X[:, 0] - xc) * np.exp(-d2 / (2 * r**2)) + 0.2 * phil[:, k]
        p[:, k] = np.exp(-d2 / (2 * r**2)) * 0.5
    return {"X": X, "t": t, "u": u, "v": v, "p": p, "phil": phil}


def load_data(data_path: Optional[str]):
    """The fields of ``data_path`` (a .mat file) when it exists, else the
    synthetic field (said on stdout)."""
    if data_path and osp.exists(data_path):
        import scipy.io

        data = scipy.io.loadmat(data_path)
        return {k: np.asarray(data[k], np.float32) for k in FIELDS}
    print(f"[bubble] DATA_PATH {data_path!r} not found -> synthetic rising-bubble field "
          "(download bubble.mat for the reference dataset)")
    return synthetic_bubble()


def build_solver(epochs: int = 10000, iters_per_epoch: int = 1, output_dir: Optional[str] = "./outputs_bubble",
                 learning_rate: float = 1e-3, data_path: Optional[str] = "bubble.mat", train_frac: float = 0.75,
                 pde_batch: Optional[int] = None, sup_batch: Optional[int] = None, eval_during_train: bool = False,
                 eval_freq: int = 1000, *, width: int = 30, num_layers: int = 9, deriv: Optional[str] = None,
                 device: DeviceLike = None) -> Solver:
    """The BubbleNet solver of the JAX example (the split and the point
    sampling seeded as there, the three networks' weights drawn in turn
    from one ``torch.Generator`` seeded 42); ``pde_batch``/``sup_batch``
    (None: the example's, every training point and min(2419, n)), ``width``
    and ``num_layers`` cut it; ``deriv`` names a derivative-path candidate
    to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    data = load_data(data_path)

    def norm(a):
        amin, amax = a.min(axis=0), a.max(axis=0)
        return (a - amin) / np.maximum(amax - amin, 1e-12)

    u_star, v_star, p_star = norm(data["u"]), norm(data["v"]), norm(data["p"])
    phil_star, t_star, x_star = data["phil"], data["t"], data["X"]
    N, T = x_star.shape[0], t_star.shape[0]
    col = lambda a: a.flatten()[:, None].astype("float32")
    xx, yy = col(np.tile(x_star[:, 0:1], (1, T))), col(np.tile(x_star[:, 1:2], (1, T)))
    tt = col(np.tile(t_star, (1, N)).T)
    u, v, p, phil = col(u_star), col(v_star), col(p_star), col(phil_star)

    rng = np.random.default_rng(42)
    idx = rng.choice(N * T, int(N * T * train_frac), replace=False)
    train_input = {"x": xx[idx], "y": yy[idx], "t": tt[idx]}
    train_label = {"u": u[idx], "v": v[idx], "p": p[idx], "phil": phil[idx]}
    test_input = {"x": xx, "y": yy, "t": tt}
    test_label = {"u": u, "v": v, "p": p, "phil": phil}

    gen = torch.Generator().manual_seed(SEED)
    nets = [MLP(("t", "x", "y"), (key,), num_layers, width, activation="tanh", generator=gen, device=device)
            for key in ("psi", "p", "phil")]
    nets[0].register_output_transform(
        lambda in_, out: {"u": ad.jacobian(out["psi"], in_["y"]), "v": -ad.jacobian(out["psi"], in_["x"])})
    model_list = ModelList(nets)

    geom = PointCloud(train_input, ("t", "x", "y"))
    n_train = len(idx)
    pde = InteriorConstraint(
        {"pressure_Poisson": lambda out: ad.hessian(out["p"], out["x"]) + ad.hessian(out["p"], out["y"])},
        {"pressure_Poisson": 0}, geom,
        {"dataset": "IterableNamedArrayDataset", "batch_size": int(pde_batch or n_train),
         "iters_per_epoch": iters_per_epoch},
        MSELoss("mean"), name="EQ")
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": train_input, "label": train_label},
         "batch_size": int(sup_batch or min(2419, n_train)), "iters_per_epoch": iters_per_epoch,
         "sampler": {"name": "BatchSampler", "drop_last": False, "shuffle": True}},
        MSELoss("mean"), name="Sup")
    validator = {
        "bubble_mse": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": test_input, "label": test_label},
             "total_size": N * T, "batch_size": min(8192, N * T),
             "sampler": {"name": "BatchSampler", "drop_last": False, "shuffle": False}},
            MSELoss("mean"), metric={"MSE": MSE()}, name="bubble_mse")
    }
    return Solver(model_list, {"Sup": sup, "EQ": pde}, output_dir, Adam(learning_rate)(model_list), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, eval_during_train=eval_during_train, eval_freq=eval_freq,
                  validator=validator, seed=SEED, device=device)


def field_mse(solver: Solver) -> dict:
    """The validator's MSE of u, v, p and phil on every point of the field."""
    return solver.eval()[1]["bubble_mse"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 10000)
    solver.train()
    print(f"bubble field MSE: {field_mse(solver)}")
