"""Aneurysm 3-D internal flow on the port (counterpart of
``examples/aneurysm.py``).

Steady Navier-Stokes (nu = 0.025 * 0.4, rho = 1) in a curved vessel with
an aneurysm bulge, read from five STL parts (inlet and outlet caps, no-slip
wall, closed surface, mid-vessel integral plane), translated and scaled as
in the JAX example. An MLP 6 x 512 with SiLU and weight normalization maps
(x, y, z) to (u, v, w, p). Constraints, each sampled once on the host and
fed whole every step:

* inlet: a parabolic profile (vmax 1.5) on ``bs_bc`` points;
* outlet: p = 0 on ``bs_bc`` points;
* no-slip: u = v = w = 0 on ``2 * bs_bc`` points;
* interior: the four NavierStokes residuals on ``bs_pde`` points;
* two integral constraints, the mass flow through the outlet and through
  the integral plane, ``NormalDotVec`` over ``bs_igc`` sets of
  ``integral_bs`` points each (weight 0.1).

All losses MSE/IntegralLoss with "sum" reduction, summed with unit weights;
Adam with ExponentialDecay(1e-3, gamma 0.95 every 15000 steps). The
derivative path is pinned only when ``deriv`` names one (on
``jet_pallas_full`` the six hidden layers run as one fused jet segment,
CUDA kernels on the GPU); unpinned, as in the JAX example, the MLP takes
the plain jet path and a long ``train()`` times the candidates first. The validator
is the JAX example's: the four NavierStokes residuals against 0 on
``val_total_size`` interior points (sampled after the constraints, from the
same ``np.random`` stream), MSE "sum" loss and an MSE metric, in batches of
``val_batch_size``; its derivatives go through the same jet path (the
forward kernel only, under ``torch.no_grad``).

The STLs are not in the repository: ``python tools/gen_aneurysm_stl.py
--out <dir>`` writes them (``dataset/aneurysm`` by default, which is where
``build_solver`` looks unless given ``stl_dir``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.constraints import BoundaryConstraint, IntegralConstraint, InteriorConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import NavierStokes, NormalDotVec
from paddlescience_torch.geometry.mesh import Mesh
from paddlescience_torch.loss.losses import IntegralLoss, MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import GeometryValidator

__all__ = ["build_solver", "STL_DIR"]

STL_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                       "dataset", "aneurysm")
PARTS = ("inlet", "outlet", "noslip", "integral", "closed")

NU, RHO, DIM = 0.025, 1.0, 3
SCALE = 0.4
CENTER = (0.35 * np.sin(np.pi / 2) / 2, 0.0, 4.0)  # rough mesh centroid
INLET_CENTER = (0.0, 0.0, 0.0)
INLET_NORMAL = (0.0, 0.0, 1.0)
INLET_VEL = 1.5
INLET_RADIUS = 0.6


def build_solver(
    stl_dir: Optional[str] = None,
    epochs: int = 100,
    iters_per_epoch: int = 100,
    bs_pde: int = 2048,
    bs_bc: int = 512,
    bs_igc: int = 1,
    integral_bs: int = 512,
    deriv: Optional[str] = None,
    device: DeviceLike = None,
    width: int = 512,
    num_layers: int = 6,
    seed: int = 42,
    log_freq: int = 100,
    output_dir: Optional[str] = "./output_aneurysm",
    val_total_size: int = 4096,
    val_batch_size: int = 2048,
) -> Solver:
    """The aneurysm solver; sizes are knobs so tests can shrink it.
    ``deriv`` names a derivative-path candidate to pin (None: none is
    pinned). The host samples draw from ``np.random`` seeded with ``seed``
    in the JAX example's order, so both packages train on the same points;
    the model's weights come from a ``torch.Generator`` seeded with
    ``seed``. Raises ``FileNotFoundError`` when the STLs are missing."""
    stl_dir = STL_DIR if stl_dir is None else stl_dir
    if not os.path.exists(os.path.join(stl_dir, "aneurysm_closed.stl")):
        raise FileNotFoundError(
            f"aneurysm STLs not found under '{stl_dir}': generate them with "
            f"`python tools/gen_aneurysm_stl.py --out {stl_dir}`")
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    np.random.seed(seed)
    model = MLP(("x", "y", "z"), ("u", "v", "w", "p"), num_layers, width, activation="silu", weight_norm=True,
                generator=torch.Generator().manual_seed(seed), device=device)
    equation = {"NavierStokes": NavierStokes(NU * SCALE, RHO, DIM, False),
                "NormalDotVec": NormalDotVec(("u", "v", "w"))}

    center = np.asarray(CENTER)
    geom = {p: Mesh(os.path.join(stl_dir, f"aneurysm_{p}.stl")).translate(-center).scale(SCALE) for p in PARTS}

    inlet_area = np.pi * INLET_RADIUS**2 * SCALE**2
    inlet_radius = INLET_RADIUS * SCALE
    flow_rate = 0.5 * INLET_VEL * inlet_area  # parabolic profile mean = vmax / 2
    inlet_c = (np.asarray(INLET_CENTER) - center) * SCALE

    def parabola(d):
        r2 = (d["x"] - inlet_c[0]) ** 2 + (d["y"] - inlet_c[1]) ** 2 + (d["z"] - inlet_c[2]) ** 2
        return INLET_VEL * np.maximum(1 - r2 / inlet_radius**2, 0.0)

    cfg = {"dataset": "IterableNamedArrayDataset", "iters_per_epoch": 1}
    same = {k: (lambda d, kk=k: d[kk]) for k in ("u", "v", "w")}
    bc_inlet = BoundaryConstraint(
        same, {"u": lambda d: INLET_NORMAL[0] * parabola(d), "v": lambda d: INLET_NORMAL[1] * parabola(d),
               "w": lambda d: INLET_NORMAL[2] * parabola(d)},
        geom["inlet"], {**cfg, "batch_size": bs_bc}, MSELoss("sum"), name="inlet")
    bc_outlet = BoundaryConstraint({"p": lambda d: d["p"]}, {"p": 0.0}, geom["outlet"],
                                   {**cfg, "batch_size": bs_bc}, MSELoss("sum"), name="outlet")
    bc_noslip = BoundaryConstraint(same, {"u": 0.0, "v": 0.0, "w": 0.0}, geom["noslip"],
                                   {**cfg, "batch_size": 2 * bs_bc}, MSELoss("sum"), name="no_slip")
    pde = InteriorConstraint(equation["NavierStokes"].equations,
                             {"continuity": 0, "momentum_x": 0, "momentum_y": 0, "momentum_z": 0},
                             geom["closed"], {**cfg, "batch_size": bs_pde}, MSELoss("sum"), name="interior")
    igc = [IntegralConstraint(equation["NormalDotVec"].equations, {"normal_dot_vec": rate}, geom[part],
                              {**cfg, "batch_size": bs_igc}, IntegralLoss("sum"), integral_batch_size=integral_bs,
                              weight_dict={"normal_dot_vec": 0.1}, name=name)
           for part, rate, name in (("outlet", flow_rate, "igc_outlet"), ("integral", -flow_rate, "igc_integral"))]
    constraint = {c.name: c for c in (bc_inlet, bc_outlet, bc_noslip, pde, *igc)}

    lr = ExponentialDecay(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3, gamma=0.95,
                          decay_steps=15000)()
    validator = {"residual": GeometryValidator(
        equation["NavierStokes"].equations, {"continuity": 0, "momentum_x": 0, "momentum_y": 0, "momentum_z": 0},
        geom["closed"], {"dataset": "NamedArrayDataset", "total_size": val_total_size, "batch_size": val_batch_size},
        MSELoss("sum"), metric={"MSE": MSE()}, name="residual")}
    return Solver(model, constraint, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  log_freq=log_freq, seed=seed, equation=equation, validator=validator, device=device)
