"""Vortex-induced vibration inverse problem on the port (counterpart of
``examples/viv.py``).

Learns the structural parameters k1, k2 of

    rho eta_tt + exp(k1) eta_t + exp(k2) eta = f(t)

from a displacement eta(t) and a force f(t) generated by integrating the
ODE with RK4 (200 points on t in [0, 10], true k1 = -4, k2 = 0), as the
JAX example does. An MLP 5 x 50 (tanh) maps t_f to eta; ``Vibration(rho=2,
k1=-1, k2=1)`` holds k1, k2 as learnable equation parameters, which the
solver optimizes with the network (Adam; the ``Step`` schedule as the JAX
example builds it: 1e-3, x 0.9 every ``step_size`` x ``iters_per_epoch`` =
20 x 20 x 20 steps, so constant over its 2000 steps). One supervised
constraint feeds all 200 points every step: MSE "mean" of eta and of the
residual f against the data (weight 10).

Run on the GPU: ``python -m paddlescience_torch.examples.viv [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import Vibration
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.optimizer.lr_scheduler import Step
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "make_viv_data", "RHO", "K1_TRUE", "K2_TRUE", "K1_INIT", "K2_INIT"]

RHO = 2.0
K1_TRUE, K2_TRUE = -4.0, 0.0
K1_INIT, K2_INIT = -1.0, 1.0


def make_viv_data(rho: float = RHO, k1_true: float = K1_TRUE, k2_true: float = K2_TRUE, n: int = 200):
    """(t, eta, f), each (n, 1) float32: rho eta'' + exp(k1) eta' + exp(k2)
    eta = f with f(t) = sin 2t + 0.5 sin 5.1t + 0.3 cos 0.7t, eta(0) = 1,
    eta'(0) = 0, integrated by RK4 on n points of [0, 10] (the JAX
    example's generator)."""
    c, k = np.exp(k1_true), np.exp(k2_true)
    f = lambda t: np.sin(2 * t) + 0.5 * np.sin(5.1 * t) + 0.3 * np.cos(0.7 * t)

    def rhs(t, state):
        eta, v = state
        return np.array([v, (f(t) - c * v - k * eta) / rho])

    ts = np.linspace(0, 10, n)
    dt = ts[1] - ts[0]
    state = np.array([1.0, 0.0])
    etas = [state[0]]
    for i in range(n - 1):
        t = ts[i]
        s1 = rhs(t, state)
        s2 = rhs(t + dt / 2, state + dt / 2 * s1)
        s3 = rhs(t + dt / 2, state + dt / 2 * s2)
        s4 = rhs(t + dt, state + dt * s3)
        state = state + dt / 6 * (s1 + 2 * s2 + 2 * s3 + s4)
        etas.append(state[0])
    return (ts.reshape(-1, 1).astype(np.float32), np.asarray(etas).reshape(-1, 1).astype(np.float32),
            f(ts).reshape(-1, 1).astype(np.float32))


def build_solver(epochs: int = 100, iters_per_epoch: int = 20, output_dir: Optional[str] = "./output_viv", *,
                 deriv: Optional[str] = None, device: DeviceLike = None, seed: int = 42,
                 log_freq: int = 200) -> Solver:
    """The viv solver of the JAX example (the model's weights from a
    ``torch.Generator`` seeded with ``seed``); ``deriv`` names a
    derivative-path candidate to pin (None: none is pinned)."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(seed)
    random.seed(seed)
    t, eta, f = make_viv_data()
    model = MLP(("t_f",), ("eta",), 5, 50, activation="tanh", generator=torch.Generator().manual_seed(seed),
                device=device)
    equation = {"VIV": Vibration(rho=RHO, k1=K1_INIT, k2=K2_INIT)}
    sup = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t_f": t}, "label": {"eta": eta, "f": f}}},
        MSELoss("mean", weight={"f": 10.0}),
        {"eta": lambda out: out["eta"], "f": equation["VIV"].equations["f"]},
        name="Sup",
    )
    lr = Step(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3, step_size=20 * iters_per_epoch,
              gamma=0.9)()
    return Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  equation=equation, log_freq=log_freq, seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 100)
    solver.train()
    print(f"k1 = {float(solver.eq_params['k1'].detach()):.6f} (true {K1_TRUE}), "
          f"k2 = {float(solver.eq_params['k2'].detach()):.6f} (true {K2_TRUE})")
