"""Allen-Cahn PINN on the port (counterpart of ``examples/allen_cahn.py``):

  u_t - 1e-4 u_xx + 5 u^3 - 5 u = 0,  (t, x) in [0, 1] x [-1, 1],
  u(0, x) = x^2 cos(pi x),  periodic in x.

Three backbones, all 256 wide with tanh, period embedding on x (period 2),
Fourier features (dim 256) and random weight factorization:

============  =========================  =============  ========
arch          net                        fourier scale  RWF mean
============  =========================  =============  ========
mlp           MLP 4 x 256                1.0            0.5
modified_mlp  ModifiedMLP 4 x 256        2.0            1.0
piratenet     PirateNet, 3 blocks x 256  2.0            1.0
              (``piratenet_blocks``)
============  =========================  =============  ========

CausalMSELoss(32 chunks, tol 1) on 4096 collocation points sampled on the
device each step, plus the initial-condition MSE on 512 points; GradNorm
(update_freq 1000, momentum 0.9); Adam with ExponentialDecay (1e-3, gamma
0.9 every 2000 steps). The derivative path is pinned to ``jet_pallas_full``:
the hidden layers (all PirateNet blocks) run as one fused jet segment (CUDA
kernels on the GPU).

The initial-condition labels are x^2 cos(pi x) on
``linspace(-1, 1, 512, endpoint=False)``, which is row 0 of the JAX
example's ETDRK4 reference solution. The L2Rel validator against that
solution and the NTK aggregator of the JAX example's ``sota`` variant are
not ported yet.

Run on the GPU:
``python -m paddlescience_torch.examples.allen_cahn [steps] [arch]``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP, ModifiedMLP, PirateNet
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.data.dataset.array_dataset import DeviceSampledDataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import AllenCahn
from paddlescience_torch.loss import mtl
from paddlescience_torch.loss.losses import CausalMSELoss, MSELoss
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "ic_data"]


def ic_data(nx: int = 512):
    """(t, x, u0) columns of the initial condition, float32."""
    x = np.linspace(-1, 1, nx, endpoint=False)
    u0 = (x**2) * np.cos(np.pi * x)
    col = lambda a: a.astype(np.float32).reshape(-1, 1)
    return col(np.zeros_like(x)), col(x), col(u0)


def build_solver(
    epochs: int = 200,
    iters_per_epoch: int = 1000,
    batch_size: int = 4096,
    seed: int = 42,
    num_layers: int = 4,
    hidden_size: int = 256,
    fourier_dim: int = 256,
    ic_points: int = 512,
    learning_rate: float = 1e-3,
    gamma: float = 0.9,
    decay_steps: int = 2000,
    update_freq: int = 1000,
    log_freq: int = 100,
    deriv: str = "jet_pallas_full",
    device: DeviceLike = None,
    arch: str = "mlp",
    piratenet_blocks: int = 3,
    fourier_scale: Optional[float] = None,
    rwf_mean: Optional[float] = None,
) -> Solver:
    """The Allen-Cahn solver with backbone ``arch`` ("mlp", "modified_mlp"
    or "piratenet"); sizes are knobs so tests can shrink it. ``deriv``
    names the derivative-path candidate to pin. ``fourier_scale`` and
    ``rwf_mean`` default per arch (2.0 and 1.0 for the gated archs, 1.0
    and 0.5 for the MLP)."""
    device = resolve_device(device)
    if arch not in ("mlp", "modified_mlp", "piratenet"):
        raise ValueError(f"arch '{arch}' not found; available: mlp, modified_mlp, piratenet")
    deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    gated = arch != "mlp"
    common = dict(
        activation="tanh",
        periods={"x": (2.0, False)},
        fourier={"dim": fourier_dim, "scale": (2.0 if gated else 1.0) if fourier_scale is None else fourier_scale},
        random_weight={"mean": (1.0 if gated else 0.5) if rwf_mean is None else rwf_mean, "std": 0.1},
        generator=torch.Generator().manual_seed(seed),
        device=device,
    )
    if arch == "piratenet":
        model = PirateNet(("t", "x"), ("u",), num_blocks=piratenet_blocks, hidden_size=hidden_size, **common)
    else:
        cls = ModifiedMLP if gated else MLP
        model = cls(("t", "x"), ("u",), num_layers=num_layers, hidden_size=hidden_size, **common)
    equation = {"AllenCahn": AllenCahn(eps=0.01)}

    t_ic, x_ic, u_ic = ic_data(ic_points)
    t0, t1 = 0.0, 1.0
    x0, x1 = float(x_ic[0, 0]), float(x_ic[-1, 0])

    def sample_fn(gen: torch.Generator):
        # t sorted: the causal loss chunks the batch in time order
        t = torch.rand(batch_size, 1, generator=gen, device=device) * (t1 - t0) + t0
        t = torch.sort(t, dim=0).values
        x = torch.rand(batch_size, 1, generator=gen, device=device) * (x1 - x0) + x0
        return {"t": t, "x": x}, {"allen_cahn": torch.zeros(batch_size, 1, device=device)}, {}

    pde = Constraint(DeviceSampledDataset(sample_fn), None, CausalMSELoss(32, "mean", tol=1.0), "PDE")
    pde.output_expr = equation["AllenCahn"].equations
    ic = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t": t_ic, "x": x_ic},
                     "label": {"u": u_ic}}},
        MSELoss("mean"),
        {"u": lambda out: out["u"]},
        name="IC",
    )
    constraint = {"PDE": pde, "IC": ic}
    lr = ExponentialDecay(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=learning_rate,
                          gamma=gamma, decay_steps=decay_steps)()
    return Solver(
        model, constraint, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
        log_freq=log_freq, seed=seed, equation=equation,
        loss_aggregator=mtl.GradNorm(model, len(constraint), update_freq, 0.9), device=device,
    )


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    build_solver(arch=sys.argv[2] if len(sys.argv) > 2 else "mlp").train(steps)
