"""DeepHPMs on 2-D Navier-Stokes vorticity transport, on the port
(counterpart of ``examples/deephpms_ns.py``).

Two stages. The identification net (MLP 4 x 200, sin) fits the vorticity
w(t, x, y) to data (MSE "sum"); then, with it frozen, the PDE net (MLP
2 x 100, sin) learns the hidden operator w_t = N(u, v, w, w_x, w_y, w_xx,
w_xy, w_yy): u, v ride through from the data, the w-derivative features
come from nested ``torch.func.jvp`` on the identification net (its input
transform feeds it (t, x, y) normalised once by the transform and once by
the net's own, as the JAX example does), and the loss is the squared
misfit of f_pde and w_t (``FunctionalLoss``). Each stage: Adam 1e-3, 60
epochs of 20 steps on the whole training set (the JAX configuration
``conf/deephpms_ns.yaml``). The data are the JAX example's in-repo
pseudo-spectral solver's (vorticity form, 2/3 de-aliasing, RK4; 96^2
points x 41 times on a periodic box, 10,000 training points) unless
``dataset_path`` names the example's .mat file.

Run on the GPU: ``python -m paddlescience_torch.examples.deephpms_ns [epochs]``.
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.arch.model_list import ModelList
from paddlescience_torch.autodiff import ad
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.deephpms import _mat_cfg
from paddlescience_torch.loss.losses import FunctionalLoss, MSELoss
from paddlescience_torch.metric import FunctionalMetric, L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["spectral_ns2d", "load_data", "make_transform_f", "stages", "run", "FEATURES"]

NU = 1e-2
T_LB, T_UB = 0.0, 2.0
BOX = 2 * np.pi
SEED = 42
FEATURES = ("u", "v", "w", "dw_x", "dw_y", "dw_xx", "dw_xy", "dw_yy")


def spectral_ns2d(nx=96, nt=41, nu=NU, seed=0):
    """Periodic 2-D NS in vorticity form, w_t + u w_x + v w_y = nu lap(w):
    (times, x, [(w, u, v) per time])."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(nx, d=1.0 / nx) * (2 * np.pi / BOX)
    KX, KY = np.meshgrid(k, k, indexing="ij")
    K2 = KX**2 + KY**2
    K2i = np.where(K2 == 0, 1.0, K2)
    wh = (rng.standard_normal((nx, nx)) + 1j * rng.standard_normal((nx, nx)))
    wh *= np.exp(-((np.sqrt(K2) - 3.0) ** 2))
    w = np.real(np.fft.ifft2(wh))
    w = 2.0 * w / np.abs(w).max()
    dealias = (np.abs(KX) < k.max() * 2 / 3) & (np.abs(KY) < k.max() * 2 / 3)

    def rhs(w):
        wh = np.fft.fft2(w)
        psih = wh / K2i
        u = np.real(np.fft.ifft2(1j * KY * psih))
        v = np.real(np.fft.ifft2(-1j * KX * psih))
        wx = np.real(np.fft.ifft2(1j * KX * wh))
        wy = np.real(np.fft.ifft2(1j * KY * wh))
        adv = np.fft.fft2(u * wx + v * wy) * dealias
        return np.real(np.fft.ifft2(-adv - nu * K2 * wh)), u, v

    ts = np.linspace(T_LB, T_UB, nt)
    sub = 40
    dt = (ts[1] - ts[0]) / sub
    snaps = []
    for it in range(nt):
        _, u, v = rhs(w)
        snaps.append((w.copy(), u, v))
        if it == nt - 1:
            break
        for _ in range(sub):
            k1, _, _ = rhs(w)
            k2, _, _ = rhs(w + 0.5 * dt * k1)
            k3, _, _ = rhs(w + 0.5 * dt * k2)
            k4, _, _ = rhs(w + dt * k3)
            w = w + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    x = np.linspace(0, BOX, nx, endpoint=False)
    return ts, x, snaps


def load_data(path: Optional[str], seed: int = 0, n_train: int = 10000, nx: int = 96, nt: int = 41):
    """The .mat file at ``path`` when it exists, else the generated field:
    t, x, y, u, v, w on every grid point (``*_star``) and ``n_train`` of
    them (``*_train``)."""
    if path and osp.exists(path):
        import scipy.io

        data = scipy.io.loadmat(path)
        return {k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items() if not k.startswith("__")}
    rng = np.random.default_rng(seed)
    ts, x, snaps = spectral_ns2d(nx=nx, nt=nt, seed=seed)
    nx = len(x)
    T = np.repeat(ts, nx * nx)
    X, Y = np.meshgrid(x, x, indexing="ij")
    XX = np.tile(X.ravel(), len(ts))
    YY = np.tile(Y.ravel(), len(ts))
    W = np.concatenate([s[0].ravel() for s in snaps])
    U = np.concatenate([s[1].ravel() for s in snaps])
    V = np.concatenate([s[2].ravel() for s in snaps])
    col = lambda a: a.reshape(-1, 1).astype("float32")
    full = dict(t_star=col(T), x_star=col(XX), y_star=col(YY), u_star=col(U), v_star=col(V), w_star=col(W))
    idx = rng.choice(len(T), min(n_train, len(T)), replace=False)
    full.update({k.replace("_star", "_train"): full[k][idx] for k in list(full)})
    return full


def _norm(a, lb, ub):
    return 2.0 * (a - lb) / (ub - lb) - 1.0


def transform_w(in_):
    return {"t": _norm(in_["t"], T_LB, T_UB), "x": _norm(in_["x"], 0.0, BOX), "y": _norm(in_["y"], 0.0, BOX)}


def make_transform_f(w_model):
    """(t, x, y, u, v) -> (u, v, w, w_x, w_y, w_xx, w_xy, w_yy) of
    ``w_model`` by nested forward-mode derivatives."""
    jvp = torch.func.jvp

    def transform_f(in_):
        t, x, y = ad.unwrap(in_["t"]), ad.unwrap(in_["x"]), ad.unwrap(in_["y"])
        key = w_model.output_keys[0]

        def w_of(xx, yy):
            return w_model({"t": _norm(t, T_LB, T_UB), "x": _norm(xx, 0.0, BOX), "y": _norm(yy, 0.0, BOX)})[key]

        ox, oy = torch.ones_like(x), torch.ones_like(y)
        w_x_of = lambda xx, yy: jvp(lambda a: w_of(a, yy), (xx,), (ox,))[1]
        w_y_of = lambda xx, yy: jvp(lambda b: w_of(xx, b), (yy,), (oy,))[1]
        return {"u": ad.unwrap(in_["u"]), "v": ad.unwrap(in_["v"]), "w": w_of(x, y), "dw_x": w_x_of(x, y),
                "dw_y": w_y_of(x, y), "dw_xx": jvp(lambda a: w_x_of(a, y), (x,), (ox,))[1],
                "dw_xy": jvp(lambda b: w_x_of(x, b), (y,), (oy,))[1],
                "dw_yy": jvp(lambda b: w_y_of(x, b), (y,), (oy,))[1]}

    return transform_f


def _pde_loss(out, *args):
    return {"pde": torch.sum((out["f_pde"] - out["dw_t"]) ** 2)}


def _pde_l2(out, *args):
    return {"f_pde": torch.linalg.norm(out["dw_t"] - out["f_pde"]) / torch.linalg.norm(out["dw_t"])}


def stages(epochs: Sequence[int] = (60, 60), iters_per_epoch: int = 20, lr: float = 1e-3,
           output_dir: Optional[str] = "./outputs_deephpms_ns", dataset_path: Optional[str] = None, nx: int = 96,
           nt: int = 41, n_eval: Optional[int] = None, *, n_train: int = 10000, width: int = 200,
           num_layers: int = 4, pde_width: int = 100, pde_layers: int = 2,
           device: DeviceLike = None) -> Iterator[Solver]:
    """The two stage solvers of the JAX example in turn, each built when
    the caller asks for it (after training the one before); ``n_eval``
    subsamples the validation points (seeded 7, as in JAX); the sizes cut
    it for tests."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    data = load_data(dataset_path, seed=0, n_train=n_train, nx=nx, nt=nt)
    if n_eval:
        sel = np.random.default_rng(7).choice(len(data["t_star"]), int(n_eval), replace=False)
        for k in list(data):
            if k.endswith("_star"):
                data[k] = data[k][sel]
    in_map = {"t": "t_train", "x": "x_train", "y": "y_train", "u": "u_train", "v": "v_train"}
    in_map_star = {k: v.replace("_train", "_star") for k, v in in_map.items()}
    idn = MLP(("t", "x", "y"), ("w_idn",), num_layers, width, activation="sin",
              generator=torch.Generator().manual_seed(SEED), device=device)
    pde_net = MLP(FEATURES, ("f_pde",), pde_layers, pde_width, activation="sin",
                  generator=torch.Generator().manual_seed(1), device=device)
    idn.register_input_transform(transform_w)
    pde_net.register_input_transform(make_transform_f(idn))
    common = dict(iters_per_epoch=iters_per_epoch, eval_during_train=False, seed=SEED, device=device)

    sup1 = SupervisedConstraint(_mat_cfg(data, in_map, {"w_idn": "w_train"}), MSELoss("sum"),
                                {"w_idn": lambda out: out["w_idn"]}, name="w_mse_sup")
    val1 = SupervisedValidator(_mat_cfg(data, in_map_star, {"w_idn": "w_star"}), MSELoss("sum"),
                               {"w_idn": lambda out: out["w_idn"]}, {"l2": L2Rel()}, name="w_L2_sup")
    yield Solver(idn, {"w_mse_sup": sup1}, output_dir, Adam(lr)(idn), epochs=epochs[0],
                 validator={"w_L2_sup": val1}, **common)

    models2 = ModelList((idn, pde_net))
    idn.freeze()
    expr2 = {"dw_t": lambda out: ad.unwrap(ad.jacobian(out["w_idn"], out["t"])),
             "f_pde": lambda out: ad.unwrap(out["f_pde"])}
    sup2 = SupervisedConstraint(_mat_cfg(data, in_map, {"dw_t": "t_train"}), FunctionalLoss(_pde_loss), expr2,
                                name="f_mse_sup")
    val2 = SupervisedValidator(_mat_cfg(data, in_map_star, {"dw_t": "t_star"}), FunctionalLoss(_pde_loss), expr2,
                               {"l2": FunctionalMetric(_pde_l2)}, name="f_L2_sup")
    yield Solver(models2, {"f_mse_sup": sup2}, output_dir, Adam(lr)(models2), epochs=epochs[1],
                 validator={"f_L2_sup": val2}, **common)


def run(cfg=None, epochs: Sequence[int] = (60, 60), iters_per_epoch: int = 20, lr: float = 1e-3,
        output_dir: Optional[str] = "./outputs_deephpms_ns", dataset_path: Optional[str] = None, **kwargs) -> float:
    """Train both stages; prints each stage's L2Rel and returns the PDE
    net's. ``kwargs`` go to :func:`stages`."""
    metric = float("nan")
    for i, solver in enumerate(stages(epochs, iters_per_epoch, lr, output_dir, dataset_path, **kwargs)):
        solver.train()
        metric, _ = solver.eval()
        print(f"stage{i + 1} {('idn', 'pde')[i]} L2Rel = {metric:.4e}")
    return metric


if __name__ == "__main__":
    argv = sys.argv[1:]
    n = int(argv[0]) if argv else 60
    run(epochs=(n, n))
