"""DeepHPMs, deep hidden physics models of 1-D evolution PDEs, on the
port (counterpart of ``examples/deephpms.py``, which the JAX package's
``deephpms_kdv`` and ``deephpms_ks`` run with ``pde="kdv"`` and
``pde="ks"``).

Three MLPs: the identification net (4 x 50, sin) fits u(t, x) to data;
the PDE net (2 x 100, sin) learns the hidden operator u_t = N(u, u_x, ...,
u_x^(p)) with p = 2 (Burgers), 3 (KdV) or 4 (Kuramoto-Sivashinsky); the
solution net (4 x 50, sin) solves the learned PDE on a second dataset with
periodic boundaries. The identification and solution nets normalise (t,
x) by an input transform; the PDE net's input transform maps the
constraint's (t, x) onto u and its x-derivatives of the identification
(then the solution) net by nested ``torch.func.jvp``, as the JAX example
does with ``jax.jvp`` (which feeds that net (t, x) normalised once by
itself and once more by the net's own transform: the port keeps that).
Three stages, each Adam 1e-3 for 60 epochs of 1 step on the whole
dataset: the identification net alone (MSE "sum"), then the PDE net with
the identification net frozen (``FunctionalLoss``: the squared misfit of
f_pde and u_t), then the solution net with the PDE net frozen (that
misfit, the periodic match of u and its x-derivatives up to order p - 1 at
128 boundary times, and u at t = 0); each stage reports its validator's
L2Rel (``FunctionalMetric`` for the second). ``dataset_path`` and
``dataset_sol_path`` name the example's .mat files; when absent, the JAX
example's numpy generators make the same layout (FFT + RK4 for Burgers,
ETDRK4 for KdV and KS; 256 points x 201 times, 10,000 training points).

Run on the GPU: ``python -m paddlescience_torch.examples.deephpms [burgers|kdv|ks] [epochs]``.
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
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss, MSELoss
from paddlescience_torch.metric import FunctionalMetric, L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["PDES", "spectral_etdrk4", "spectral_burgers", "load_data", "make_transform_u", "make_transform_f",
           "build_nets", "stages", "run"]

T_LB, T_UB = 0.0, 10.0
X_LB, X_UB = -8.0, 8.0
NU = 0.1
SEED = 42

# u_t = lin(d/dx) u + N(u), N(u) = -u u_x for all three; order: the PDE net's derivative features
PDES = {
    "burgers": dict(t=(0.0, 10.0), x=(-8.0, 8.0), order=2, lin=lambda k: -NU * k**2, dt=None),
    "kdv": dict(t=(0.0, 40.0), x=(-20.0, 20.0), order=3, lin=lambda k: 1j * k**3, dt=1e-3),
    "ks": dict(t=(0.0, 50.0), x=(-10.0, 10.0), order=4, lin=lambda k: k**2 - k**4, dt=2.5e-3),
}


def spectral_etdrk4(pde: str, nx: int = 256, nt: int = 201, seed: int = 0, amp: float = 1.0):
    """Periodic 1-D spectral solve of u_t = lin u - u u_x by ETDRK4 (Kassam
    and Trefethen 2005; a complex contour: KdV's lin is imaginary)."""
    spec = PDES[pde]
    (t0, t1), (x0, x1) = spec["t"], spec["x"]
    L = x1 - x0
    rng = np.random.default_rng(seed)
    x = np.linspace(x0, x1, nx, endpoint=False)
    k = 2 * np.pi * np.fft.fftfreq(nx, d=L / nx)
    u = -amp * np.sin(2 * np.pi * (x - x0) / L) + 0.1 * rng.standard_normal() * np.cos(4 * np.pi * (x - x0) / L)
    lin = spec["lin"](k).astype(np.complex128)
    dt = spec["dt"]
    steps_total = int(round((t1 - t0) / dt))
    save_every = max(steps_total // (nt - 1), 1)
    E = np.exp(dt * lin)
    E2 = np.exp(dt * lin / 2)
    M = 32
    r = np.exp(2j * np.pi * (np.arange(1, M + 1) - 0.5) / M)
    LR = dt * lin[:, None] + r[None, :]
    Q = dt * np.mean((np.exp(LR / 2) - 1) / LR, axis=1)
    f1 = dt * np.mean((-4 - LR + np.exp(LR) * (4 - 3 * LR + LR**2)) / LR**3, axis=1)
    f2 = dt * np.mean((2 + LR + np.exp(LR) * (-2 + LR)) / LR**3, axis=1)
    f3 = dt * np.mean((-4 - 3 * LR - LR**2 + np.exp(LR) * (4 - LR)) / LR**3, axis=1)

    def N_of(v_hat):
        uu = np.real(np.fft.ifft(v_hat))
        return -0.5j * k * np.fft.fft(uu * uu)  # -u u_x = -(u^2 / 2)_x

    v = np.fft.fft(u)
    out = [u.copy()]
    for step in range(1, steps_total + 1):
        Nv = N_of(v)
        a = E2 * v + Q * Nv
        Na = N_of(a)
        b = E2 * v + Q * Na
        Nb = N_of(b)
        c = E2 * a + Q * (2 * Nb - Nv)
        Nc = N_of(c)
        v = E * v + Nv * f1 + 2 * (Na + Nb) * f2 + Nc * f3
        if step % save_every == 0 and len(out) < nt:
            out.append(np.real(np.fft.ifft(v)))
    while len(out) < nt:
        out.append(out[-1])
    return np.linspace(t0, t1, nt), x, np.stack(out)


def spectral_burgers(nx: int = 256, nt: int = 201, nu: float = NU, seed: int = 0, amp: float = 1.0):
    """Periodic viscous Burgers u_t = -u u_x + nu u_xx by FFT + RK4."""
    rng = np.random.default_rng(seed)
    x = np.linspace(X_LB, X_UB, nx, endpoint=False)
    L = X_UB - X_LB
    k = 2 * np.pi * np.fft.fftfreq(nx, d=L / nx)
    u = -amp * np.sin(2 * np.pi * (x - X_LB) / L) + 0.1 * rng.standard_normal() * np.cos(4 * np.pi * (x - X_LB) / L)
    ts = np.linspace(T_LB, T_UB, nt)
    sub = 20
    dt = (ts[1] - ts[0]) / sub

    def rhs(u):
        uh = np.fft.fft(u)
        ux = np.real(np.fft.ifft(1j * k * uh))
        uxx = np.real(np.fft.ifft(-(k**2) * uh))
        return -u * ux + nu * uxx

    snaps = [u.copy()]
    for _ in range(nt - 1):
        for _ in range(sub):
            k1 = rhs(u)
            k2 = rhs(u + 0.5 * dt * k1)
            k3 = rhs(u + 0.5 * dt * k2)
            k4 = rhs(u + dt * k3)
            u = u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        snaps.append(u.copy())
    return ts, x, np.stack(snaps)


def _flatten(ts, x, U, n_train, rng):
    T, X = np.meshgrid(ts, x, indexing="ij")
    t_star = T.reshape(-1, 1).astype("float32")
    x_star = X.reshape(-1, 1).astype("float32")
    u_star = U.reshape(-1, 1).astype("float32")
    idx = rng.choice(len(t_star), n_train, replace=False)
    return dict(t_train=t_star[idx], x_train=x_star[idx], u_train=u_star[idx], t_star=t_star, x_star=x_star,
                u_star=u_star)


def load_data(path: Optional[str], seed: int, n_train: int = 10000, pde: str = "burgers"):
    """The .mat file at ``path`` when it exists (t_train, x_train, u_train,
    t_star, x_star, u_star), else the generated field of ``pde``."""
    if path and osp.exists(path):
        import scipy.io

        data = scipy.io.loadmat(path)
        keys = ("t_train", "x_train", "u_train", "t_star", "x_star", "u_star")
        return {k: np.asarray(data[k], np.float32).reshape(-1, 1) for k in keys}
    rng = np.random.default_rng(seed)
    if pde == "burgers":
        ts, x, U = spectral_burgers(seed=seed, amp=1.0 + 0.2 * seed)
    else:
        ts, x, U = spectral_etdrk4(pde, seed=seed, amp=1.0 + 0.2 * seed)
    return _flatten(ts, x, U, n_train, rng)


def _normalizers(pde):
    (t_lb, t_ub), (x_lb, x_ub) = PDES[pde]["t"], PDES[pde]["x"]
    return (lambda t: 2.0 * (t - t_lb) / (t_ub - t_lb) - 1.0), (lambda x: 2.0 * (x - x_lb) / (x_ub - x_lb) - 1.0)


def _deriv_keys(order):
    """The PDE net's feature names: u itself under "u_x" (sic), then du_x, du_xx, ..."""
    return ["u_x"] + ["du_" + "x" * j for j in range(1, order + 1)]


def make_transform_u(pde: str = "burgers"):
    """(t, x) -> their normalisation to [-1, 1]."""
    norm_t, norm_x = _normalizers(pde)
    return lambda in_: {"t": norm_t(in_["t"]), "x": norm_x(in_["x"])}


def make_transform_f(u_model, pde: str = "burgers"):
    """(t, x) -> (u, u_x, ..., u_x^(order)) of ``u_model`` by nested
    forward-mode derivatives along x."""
    order = PDES[pde]["order"]
    norm_t, norm_x = _normalizers(pde)
    keys = _deriv_keys(order)

    def transform_f(in_):
        t, x = ad.unwrap(in_["t"]), ad.unwrap(in_["x"])
        key = u_model.output_keys[0]
        ones = torch.ones_like(x)
        fn = lambda xx: u_model({"t": norm_t(t), "x": norm_x(xx)})[key]
        out = {}
        out[keys[0]], out[keys[1]] = torch.func.jvp(fn, (x,), (ones,))
        for j in range(2, order + 1):
            fn = (lambda f: lambda xx: torch.func.jvp(f, (xx,), (ones,))[1])(fn)
            out[keys[j]] = torch.func.jvp(fn, (x,), (ones,))[1]
        return out

    return transform_f


def _nth_jac(u, x, n):
    for _ in range(n):
        u = ad.jacobian(u, x)
    return u


def _pde_loss(out, *args):
    return {"pde": torch.sum((out["f_pde"] - out["du_t"]) ** 2)}


def _pde_l2(out, *args):
    return {"f_pde": torch.linalg.norm(out["du_t"] - out["f_pde"]) / torch.linalg.norm(out["du_t"])}


def _boundary_loss(out, *args):
    """Periodic match of u and every given x-derivative (first half of the
    rows at x_lb against the second at x_ub)."""
    total = 0.0
    for k, v in out.items():
        if k == "u_sol" or k.startswith("du_"):
            n = v.shape[0] // 2
            total = total + torch.sum((v[:n] - v[n:]) ** 2)
    return {"boundary": total}


def _mat_cfg(data, in_map, lab_map):
    return {"dataset": {"name": "NamedArrayDataset", "input": {k: data[v] for k, v in in_map.items()},
                        "label": {k: data[v] for k, v in lab_map.items()}},
            "batch_size": len(data[next(iter(in_map.values()))]), "iters_per_epoch": 1,
            "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}}


def build_nets(pde: str = "burgers", *, width: int = 50, num_layers: int = 4, pde_width: int = 100,
               pde_layers: int = 2, device: DeviceLike = None):
    """The identification, PDE and solution nets with their transforms
    (weights from ``torch.Generator``s seeded 42, 1 and 2, the JAX
    example's ``Rngs``)."""
    order = PDES[pde]["order"]
    idn = MLP(("t", "x"), ("u_idn",), num_layers, width, activation="sin",
              generator=torch.Generator().manual_seed(SEED), device=device)
    pde_net = MLP(tuple(_deriv_keys(order)), ("f_pde",), pde_layers, pde_width, activation="sin",
                  generator=torch.Generator().manual_seed(1), device=device)
    sol = MLP(("t", "x"), ("u_sol",), num_layers, width, activation="sin", generator=torch.Generator().manual_seed(2),
              device=device)
    idn.register_input_transform(make_transform_u(pde))
    sol.register_input_transform(make_transform_u(pde))
    pde_net.register_input_transform(make_transform_f(idn, pde))
    return idn, pde_net, sol


def stages(epochs: Sequence[int] = (60, 60, 60), iters_per_epoch: int = 1, lr: float = 1e-3,
           output_dir: Optional[str] = "./outputs_deephpms", dataset_path: Optional[str] = None,
           dataset_sol_path: Optional[str] = None, pde: str = "burgers", *, n_train: int = 10000, width: int = 50,
           num_layers: int = 4, pde_width: int = 100, pde_layers: int = 2, deriv: Optional[str] = None,
           device: DeviceLike = None) -> Iterator[Solver]:
    """The three stage solvers of the JAX example in turn: each is built
    when the caller asks for it, after training the one before (the next
    stage reads the trained nets). ``n_train``, the widths and depths cut
    it for tests; ``deriv`` names a derivative-path candidate to pin."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(SEED)
    random.seed(SEED)
    order = PDES[pde]["order"]
    data_idn = load_data(dataset_path, seed=0, n_train=n_train, pde=pde)
    data_sol = load_data(dataset_sol_path, seed=1, n_train=n_train, pde=pde)
    idn, pde_net, sol = build_nets(pde, width=width, num_layers=num_layers, pde_width=pde_width,
                                   pde_layers=pde_layers, device=device)
    common = dict(iters_per_epoch=iters_per_epoch, eval_during_train=False, seed=SEED, device=device)

    # stage 1: the identification net fits u(t, x)
    sup1 = SupervisedConstraint(_mat_cfg(data_idn, {"t": "t_train", "x": "x_train"}, {"u_idn": "u_train"}),
                                MSELoss("sum"), {"u_idn": lambda out: out["u_idn"]}, name="u_mse_sup")
    val1 = SupervisedValidator(_mat_cfg(data_idn, {"t": "t_star", "x": "x_star"}, {"u_idn": "u_star"}),
                               MSELoss("sum"), {"u_idn": lambda out: out["u_idn"]}, {"l2": L2Rel()}, name="u_L2_sup")
    yield Solver(idn, {"u_mse_sup": sup1}, output_dir, Adam(lr)(idn), epochs=epochs[0],
                 validator={"u_L2_sup": val1}, **common)

    # stage 2: the PDE net learns u_t = N(u, u_x, ...) from the frozen identification net
    model_list2 = ModelList((idn, pde_net))
    idn.freeze()
    du_t = lambda out: ad.unwrap(ad.jacobian(out["u_idn"], out["t"]))
    f_pde = lambda out: ad.unwrap(out["f_pde"])
    sup2 = SupervisedConstraint(_mat_cfg(data_idn, {"t": "t_train", "x": "x_train"}, {"du_t": "t_train"}),
                                FunctionalLoss(_pde_loss), {"du_t": du_t, "f_pde": f_pde}, name="f_mse_sup")
    val2 = SupervisedValidator(_mat_cfg(data_idn, {"t": "t_star", "x": "x_star"}, {"du_t": "t_star"}),
                               FunctionalLoss(_pde_loss), {"du_t": du_t, "f_pde": f_pde},
                               {"l2": FunctionalMetric(_pde_l2)}, name="f_L2_sup")
    yield Solver(model_list2, {"f_mse_sup": sup2}, output_dir, Adam(lr)(model_list2), epochs=epochs[1],
                 validator={"f_L2_sup": val2}, **common)

    # stage 3: the solution net solves the learned PDE (the PDE net frozen, now fed by the solution net)
    pde_net.register_input_transform(make_transform_f(sol, pde))
    pde_net.freeze()
    model_list3 = ModelList((sol, pde_net))
    (t_lb, t_ub), (x_lb, x_ub) = PDES[pde]["t"], PDES[pde]["x"]
    nt_b = 128
    t_b = np.random.default_rng(3).uniform(t_lb, t_ub, (nt_b, 1)).astype("float32")
    bc_input = {"t": np.concatenate([t_b, t_b]),
                "x": np.concatenate([np.full((nt_b, 1), x_lb, "float32"), np.full((nt_b, 1), x_ub, "float32")])}
    sup3_pde = SupervisedConstraint(
        _mat_cfg(data_sol, {"t": "t_train", "x": "x_train"}, {"du_t": "t_train"}), FunctionalLoss(_pde_loss),
        {"du_t": lambda out: ad.unwrap(ad.jacobian(out["u_sol"], out["t"])), "f_pde": f_pde}, name="f_mse_sup")
    sup3_bc = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": bc_input,
                     "label": {"boundary": np.zeros((2 * nt_b, 1), "float32")}},
         "batch_size": 2 * nt_b, "iters_per_epoch": 1,
         "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}},
        FunctionalLoss(_boundary_loss),
        {"u_sol": lambda out: ad.unwrap(out["u_sol"]),
         **{f"du_{'x' * j}_sol": (lambda j: lambda out: ad.unwrap(_nth_jac(out["u_sol"], out["x"], j)))(j)
            for j in range(1, order)}},
        name="b_mse_sup")
    sup3_ic = SupervisedConstraint(
        _mat_cfg({**data_sol, "t0": np.zeros_like(data_sol["x_star"][:256]), "x0": data_sol["x_star"][:256],
                  "u0": data_sol["u_star"][:256]}, {"t": "t0", "x": "x0"}, {"u_sol": "u0"}),
        MSELoss("sum"), {"u_sol": lambda out: out["u_sol"]}, name="init_mse_sup")
    val3 = SupervisedValidator(_mat_cfg(data_sol, {"t": "t_star", "x": "x_star"}, {"u_sol": "u_star"}),
                               MSELoss("sum"), {"u_sol": lambda out: out["u_sol"]}, {"l2": L2Rel()}, name="u_L2_sup")
    yield Solver(model_list3, {"f_mse_sup": sup3_pde, "b_mse_sup": sup3_bc, "init_mse_sup": sup3_ic}, output_dir,
                 Adam(lr)(model_list3), epochs=epochs[2], validator={"u_L2_sup": val3}, **common)


def run(cfg=None, epochs: Sequence[int] = (60, 60, 60), iters_per_epoch: int = 1, lr: float = 1e-3,
        output_dir: Optional[str] = "./outputs_deephpms", dataset_path: Optional[str] = None,
        dataset_sol_path: Optional[str] = None, pde: str = "burgers", **kwargs) -> float:
    """Train the three stages (``cfg`` is unused, as in the JAX ``run``);
    prints each stage's L2Rel and returns the solution net's. ``kwargs``
    go to :func:`stages`."""
    metric = float("nan")
    for i, solver in enumerate(stages(epochs, iters_per_epoch, lr, output_dir, dataset_path, dataset_sol_path, pde,
                                      **kwargs)):
        solver.train()
        metric, _ = solver.eval()
        print(f"stage{i + 1} {('idn', 'pde', 'sol')[i]} L2Rel = {metric:.4e}")
    return metric


if __name__ == "__main__":
    argv = sys.argv[1:]
    n = int(argv[1]) if len(argv) > 1 else 60
    run(pde=argv[0] if argv else "burgers", epochs=(n, n, n))
