"""DeepHPMs on the nonlinear Schrodinger equation, on the port
(counterpart of ``examples/deephpms_schrodinger.py``).

h = u + i v solves i h_t + 0.5 h_xx + |h|^2 h = 0 on t in [0, pi/2],
x in [-5, 5]. Three stages on four nets: two identification nets (MLP 4 x
50, sin) fit u and v (MSE "sum"); with them frozen, two PDE nets (MLP 2 x
100, sin) learn u_t = f(u, v, u_x, v_x, u_xx, v_xx) and v_t = g(...), the
features from nested ``torch.func.jvp`` on the identification nets;
then, with the PDE nets frozen, the identification nets are trained again
as solutions of the learned system: the PDE misfit, the periodic match of
u, v, u_x, v_x at x = -5 and 5 on 128 times, and u, v at t = 0 on 256
points. Each stage: Adam 1e-3, 60 epochs of 20 steps on the whole training
set (the JAX configuration ``conf/deephpms_schrodinger.yaml``). The data
are the JAX example's in-repo split-step Fourier solver's (Strang
splitting, a 2 sech(x) soliton; 256 points x 201 times, 10,000 training
points) unless ``dataset_path`` names the example's .mat file.

Run on the GPU: ``python -m paddlescience_torch.examples.deephpms_schrodinger [epochs]``.
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

__all__ = ["split_step_nls", "load_data", "make_transform_fg", "stages", "run", "FEATURES"]

T_LB, T_UB = 0.0, float(np.pi / 2)
X_LB, X_UB = -5.0, 5.0
SEED = 42
FEATURES = ("u", "v", "du_x", "dv_x", "du_xx", "dv_xx")


def split_step_nls(nx=256, nt=201, seed=0, amp=2.0):
    """i h_t + 0.5 h_xx + |h|^2 h = 0 by periodic split-step Fourier:
    (times, x, h of shape (nt, nx))."""
    rng = np.random.default_rng(seed)
    x = np.linspace(X_LB, X_UB, nx, endpoint=False)
    L = X_UB - X_LB
    k = 2 * np.pi * np.fft.fftfreq(nx, d=L / nx)
    h = amp / np.cosh(x) * (1.0 + 0.05 * rng.standard_normal() * np.cos(2 * np.pi * x / L))
    h = h.astype(np.complex128)
    ts = np.linspace(T_LB, T_UB, nt)
    sub = 50
    dt = (ts[1] - ts[0]) / sub
    lin_half = np.exp(-0.25j * k**2 * dt)
    snaps = [h.copy()]
    for _ in range(nt - 1):
        for _ in range(sub):
            h = np.fft.ifft(lin_half * np.fft.fft(h))
            h = h * np.exp(1j * np.abs(h) ** 2 * dt)
            h = np.fft.ifft(lin_half * np.fft.fft(h))
        snaps.append(h.copy())
    return ts, x, np.stack(snaps)


def load_data(path: Optional[str], seed: int, n_train: int = 10000, nx: int = 256, nt: int = 201):
    """The .mat file at ``path`` when it exists, else the generated field."""
    if path and osp.exists(path):
        import scipy.io

        data = scipy.io.loadmat(path)
        return {k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items() if not k.startswith("__")}
    rng = np.random.default_rng(seed)
    ts, x, H = split_step_nls(nx=nx, nt=nt, seed=seed)
    T, X = np.meshgrid(ts, x, indexing="ij")
    t_star = T.reshape(-1, 1).astype("float32")
    x_star = X.reshape(-1, 1).astype("float32")
    u_star = np.real(H).reshape(-1, 1).astype("float32")
    v_star = np.imag(H).reshape(-1, 1).astype("float32")
    idx = rng.choice(len(t_star), n_train, replace=False)
    return dict(t_train=t_star[idx], x_train=x_star[idx], u_train=u_star[idx], v_train=v_star[idx],
                t_star=t_star, x_star=x_star, u_star=u_star, v_star=v_star)


def _norm(t, lb, ub):
    return 2.0 * (t - lb) / (ub - lb) - 1.0


def transform_uv(in_):
    return {"t": _norm(in_["t"], T_LB, T_UB), "x": _norm(in_["x"], X_LB, X_UB)}


def make_transform_fg(u_model, v_model):
    """(t, x) -> (u, v, u_x, v_x, u_xx, v_xx) of the two nets by nested
    forward-mode derivatives along x."""
    jvp = torch.func.jvp

    def transform_fg(in_):
        t, x = ad.unwrap(in_["t"]), ad.unwrap(in_["x"])
        ones = torch.ones_like(x)
        out = {}
        for name, model in (("u", u_model), ("v", v_model)):
            key = model.output_keys[0]
            w_of_x = (lambda m, k: lambda xx: m({"t": _norm(t, T_LB, T_UB), "x": _norm(xx, X_LB, X_UB)})[k])(model,
                                                                                                        key)
            val, d1 = jvp(w_of_x, (x,), (ones,))
            d2 = jvp(lambda xx: jvp(w_of_x, (xx,), (ones,))[1], (x,), (ones,))[1]
            out[name], out[f"d{name}_x"], out[f"d{name}_xx"] = val, d1, d2
        return out

    return transform_fg


def _pde_loss(out, *args):
    return {"pde": torch.sum((out["f_pde"] - out["du_t"]) ** 2) + torch.sum((out["g_pde"] - out["dv_t"]) ** 2)}


def _pde_l2(out, *args):
    return {"f_pde": torch.linalg.norm(out["du_t"] - out["f_pde"]) / torch.linalg.norm(out["du_t"]),
            "g_pde": torch.linalg.norm(out["dv_t"] - out["g_pde"]) / torch.linalg.norm(out["dv_t"])}


def _boundary_loss(out, *args):
    """Periodic match of u, v, u_x, v_x (first half of the rows at x = -5
    against the second at x = 5)."""
    total = 0.0
    for v in out.values():
        n = v.shape[0] // 2
        total = total + torch.sum((v[:n] - v[n:]) ** 2)
    return {"boundary": total}


def _uv_l2(out, label):
    pred = torch.sqrt(out["u_idn"] ** 2 + out["v_idn"] ** 2)
    true = torch.sqrt(label["u_idn"] ** 2 + label["v_idn"] ** 2)
    return {"uv_sol": torch.linalg.norm(true - pred) / torch.linalg.norm(true)}


def stages(epochs: Sequence[int] = (60, 60, 60), iters_per_epoch: int = 20, lr: float = 1e-3,
           output_dir: Optional[str] = "./outputs_deephpms_schrodinger", dataset_path: Optional[str] = None,
           dataset_sol_path: Optional[str] = None, *, n_train: int = 10000, nx: int = 256, nt: int = 201,
           width: int = 50, num_layers: int = 4, pde_width: int = 100, pde_layers: int = 2,
           device: DeviceLike = None) -> Iterator[Solver]:
    """The three stage solvers of the JAX example in turn, each built when
    the caller asks for it (after training the one before); the sizes cut
    it for tests."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    data_idn = load_data(dataset_path, seed=0, n_train=n_train, nx=nx, nt=nt)
    data_sol = load_data(dataset_sol_path, seed=1, n_train=n_train, nx=nx, nt=nt) if dataset_sol_path else data_idn
    mk = lambda keys, out, w, n, seed: MLP(keys, out, n, w, activation="sin",
                                           generator=torch.Generator().manual_seed(seed), device=device)
    model_u = mk(("t", "x"), ("u_idn",), width, num_layers, SEED)
    model_v = mk(("t", "x"), ("v_idn",), width, num_layers, 1)
    model_f = mk(FEATURES, ("f_pde",), pde_width, pde_layers, 2)
    model_g = mk(FEATURES, ("g_pde",), pde_width, pde_layers, 3)
    model_u.register_input_transform(transform_uv)
    model_v.register_input_transform(transform_uv)
    fg = make_transform_fg(model_u, model_v)
    model_f.register_input_transform(fg)
    model_g.register_input_transform(fg)
    common = dict(iters_per_epoch=iters_per_epoch, eval_during_train=False, seed=SEED, device=device)
    tx, tx_star = {"t": "t_train", "x": "x_train"}, {"t": "t_star", "x": "x_star"}

    models1 = ModelList((model_u, model_v))
    expr_uv = {k: (lambda kk: lambda out: out[kk])(k) for k in ("u_idn", "v_idn")}
    sup1 = SupervisedConstraint(_mat_cfg(data_idn, tx, {"u_idn": "u_train", "v_idn": "v_train"}), MSELoss("sum"),
                                expr_uv, name="uv_mse_sup")
    val1 = SupervisedValidator(_mat_cfg(data_idn, tx_star, {"u_idn": "u_star", "v_idn": "v_star"}), MSELoss("sum"),
                               expr_uv, {"l2": L2Rel()}, name="uv_L2_sup")
    yield Solver(models1, {"uv_mse_sup": sup1}, output_dir, Adam(lr)(models1), epochs=epochs[0],
                 validator={"uv_L2_sup": val1}, **common)

    models2 = ModelList((model_u, model_v, model_f, model_g))
    model_u.freeze()
    model_v.freeze()
    expr2 = {"du_t": lambda out: ad.unwrap(ad.jacobian(out["u_idn"], out["t"])),
             "dv_t": lambda out: ad.unwrap(ad.jacobian(out["v_idn"], out["t"])),
             "f_pde": lambda out: ad.unwrap(out["f_pde"]),
             "g_pde": lambda out: ad.unwrap(out["g_pde"])}
    sup2 = SupervisedConstraint(_mat_cfg(data_idn, tx, {"du_t": "t_train"}), FunctionalLoss(_pde_loss), expr2,
                                name="fg_mse_sup")
    val2 = SupervisedValidator(_mat_cfg(data_idn, tx_star, {"du_t": "t_star"}), FunctionalLoss(_pde_loss), expr2,
                               {"l2": FunctionalMetric(_pde_l2)}, name="fg_L2_sup")
    yield Solver(models2, {"fg_mse_sup": sup2}, output_dir, Adam(lr)(models2), epochs=epochs[1],
                 validator={"fg_L2_sup": val2}, **common)

    model_u.unfreeze()
    model_v.unfreeze()
    model_f.freeze()
    model_g.freeze()
    models3 = ModelList((model_u, model_v, model_f, model_g))
    nt_b = 128
    t_b = np.random.default_rng(3).uniform(T_LB, T_UB, (nt_b, 1)).astype("float32")
    bc_input = {"t": np.concatenate([t_b, t_b]),
                "x": np.concatenate([np.full((nt_b, 1), X_LB, "float32"), np.full((nt_b, 1), X_UB, "float32")])}
    sup3_pde = SupervisedConstraint(_mat_cfg(data_sol, tx, {"du_t": "t_train"}), FunctionalLoss(_pde_loss), expr2,
                                    name="fg_mse_sup")
    sup3_bc = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": bc_input,
                     "label": {"boundary": np.zeros((2 * nt_b, 1), "float32")}},
         "batch_size": 2 * nt_b, "iters_per_epoch": 1,
         "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}},
        FunctionalLoss(_boundary_loss),
        {"u_sol": lambda out: ad.unwrap(out["u_idn"]), "v_sol": lambda out: ad.unwrap(out["v_idn"]),
         "du_x_sol": lambda out: ad.unwrap(ad.jacobian(out["u_idn"], out["x"])),
         "dv_x_sol": lambda out: ad.unwrap(ad.jacobian(out["v_idn"], out["x"]))},
        name="b_mse_sup")
    n0 = 256
    sup3_ic = SupervisedConstraint(
        _mat_cfg({**data_sol, "t0": np.zeros_like(data_sol["x_star"][:n0]), "x0": data_sol["x_star"][:n0],
                  "u0": data_sol["u_star"][:n0], "v0": data_sol["v_star"][:n0]},
                 {"t": "t0", "x": "x0"}, {"u_idn": "u0", "v_idn": "v0"}),
        MSELoss("sum"), expr_uv, name="init_mse_sup")
    val3 = SupervisedValidator(_mat_cfg(data_sol, tx_star, {"u_idn": "u_star", "v_idn": "v_star"}), MSELoss("sum"),
                               expr_uv, {"l2": FunctionalMetric(_uv_l2)}, name="uv_sol_L2")
    yield Solver(models3, {"fg_mse_sup": sup3_pde, "b_mse_sup": sup3_bc, "init_mse_sup": sup3_ic}, output_dir,
                 Adam(lr)(models3), epochs=epochs[2], validator={"uv_sol_L2": val3}, **common)


def run(cfg=None, epochs: Sequence[int] = (60, 60, 60), iters_per_epoch: int = 20, lr: float = 1e-3,
        output_dir: Optional[str] = "./outputs_deephpms_schrodinger", dataset_path: Optional[str] = None,
        dataset_sol_path: Optional[str] = None, **kwargs) -> float:
    """Train the three stages; prints each stage's L2Rel and returns the
    solution's. ``kwargs`` go to :func:`stages`."""
    metric = float("nan")
    for i, solver in enumerate(stages(epochs, iters_per_epoch, lr, output_dir, dataset_path, dataset_sol_path,
                                      **kwargs)):
        solver.train()
        metric, _ = solver.eval()
        print(f"stage{i + 1} {('idn', 'pde', 'sol')[i]} L2Rel = {metric:.4e}")
    return metric


if __name__ == "__main__":
    argv = sys.argv[1:]
    n = int(argv[0]) if argv else 60
    run(epochs=(n, n, n))
