"""Steady lid-driven cavity, Re-curriculum recipes on the port (counterpart
of ``examples/_ldc_common.py`` and its three entry points
``ldc_2d_Re3200_piratenet.py``, ``ldc_2d_Re3200_sota.py`` and
``ldc_2d_Re1000_plain.py``).

A net maps (x, y) in the unit square to (u, v, p). Each stage of the
curriculum trains the steady ``NavierStokes(1 / Re, 1, 2, False)``
residuals on a uniform batch drawn on the device every step and the walls
(``boundary_points``: 4 x ``bs_bc`` points, the regularised lid
u = 1 - cosh(50 (x - 1/2)) / cosh(25) on top, u = v = 0 elsewhere), with
GradNorm over the five per-key losses [PDE.continuity, PDE.momentum_x,
PDE.momentum_y, BC.u, BC.v] (``loss_granularity="key"``, in that order:
``init_weights`` follow it). One model, one Adam with one
``ExponentialDecay`` (with warmup) over the sum of every stage's epochs, and
one GradNorm serve every stage: each stage's solver takes the previous
one's ``state`` (parameters, Adam moments and count, the step the
schedule reads, the GradNorm weights, the batch generator), captures its
own CUDA graphs and releases them when it is done. As in the JAX
package, the GradNorm refresh falls on the multiples of ``update_freq`` of
each stage's own step count (every stage boundary is one of them in the
three recipes).

After each stage ``U_validator`` scores U = sqrt(u^2 + v^2) against the
reference field (``data/dataset/ldc_reference.py``, solved on the device
at first use and cached) on its n x n grid, in batches of ``eval_batch``
(16384); its loader drops the short last batch, as the JAX loader does,
so the 257^2 grid scores its first 65536 of 66049 points. A Ghia-profile
RMSE (``utils/ghia.py``; Re 100 and 1000 only) is printed beside it.

The recipes (:func:`re3200_piratenet`, :func:`re3200_sota`,
:func:`re1000_plain`; ``RECIPES``) carry the numbers of
``examples/conf/ldc_2d_*.yaml``; every number is a knob, so tests can cut
them:

================  ============================  ================  ============================  ==========  =====  ===================  ======
recipe            net                           Fourier (dim, s)  Re                            epochs      PDE    GradNorm init         decay
================  ============================  ================  ============================  ==========  =====  ===================  ======
re3200_piratenet  PirateNet 4 blocks x 256      256, 15           100, 400, 1000, 1600, 3200    10 20 50    4096   10, 1, 1, 100, 100   10000
                                                                                                50 500
re3200_sota       ModifiedMLP 5 x 256           128, 10           100, 400, 1000, 3200          50 50 100   8192   10, 1, 1, 100, 100   10000
                                                                                                500
re1000_plain      MLP 4 x 256                   none              100, 400, 1000                20 40 140   4096   1, 1, 1, 1, 1        2000
================  ============================  ================  ============================  ==========  =====  ===================  ======

All three: tanh, 1000 steps an epoch, BC 4 x 256, lr 1e-3 decaying by 0.9
every ``decay`` steps, 5 warmup epochs (none for the plain MLP), RWF(1.0,
0.1) on the gated nets, GradNorm every 1000 steps with momentum 0.9.

``mixed_curriculum_precision`` (default off, as in the JAX recipes) is the
JAX recipe's knob that lowers the matmul precision in the warm-up stages:
here it allows TF32 in torch's matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32``, ``torch.backends.cudnn.allow_tf32``)
for every stage but the last, and restores float32 for the last stage and
after the run, whether it ends normally or raises
(:func:`stage_precision`). The hand-written jet kernels are not torch
matmuls: they keep their 3xTF32 products (``ops/jet_mlp.py``) in every
stage.

Run on the GPU: ``python -m paddlescience_torch.examples.ldc_curriculum
[recipe]`` (default ``re3200_piratenet``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP, ModifiedMLP, PirateNet
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.data.dataset import ldc_reference
from paddlescience_torch.data.dataset.array_dataset import DeviceSampledDataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.equation.pde.basic import NavierStokes
from paddlescience_torch.loss import mtl
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.utils import ghia
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["re3200_piratenet", "re3200_sota", "re1000_plain", "RECIPES", "lid_velocity", "boundary_points",
           "make_model", "make_training", "build_stage_solver", "train_curriculum", "stage_precision", "ghia_report",
           "evaluate"]

_COMMON = dict(input_keys=("x", "y"), output_keys=("u", "v", "p"), hidden_size=256, activation="tanh",
               iters_per_epoch=1000, learning_rate=1e-3, gamma=0.9, decay_steps=10000, warmup_epoch=5,
               bs_pde=4096, bs_bc=256, update_freq=1000, momentum=0.9, init_weights=(10, 1, 1, 100, 100),
               eval_batch=16384, eval_during_train=False, eval_freq=10, log_freq=100, seed=42,
               mixed_curriculum_precision=False,
               reference_n=ldc_reference.DEFAULT_N, reference_dir=None)


def re3200_piratenet(**overrides) -> Dict:
    """``conf/ldc_2d_Re3200_piratenet.yaml``: PirateNet 4 blocks x 256."""
    return {**_COMMON, "arch": "piratenet", "num_blocks": 4, "fourier": {"dim": 256, "scale": 15.0},
            "random_weight": {"mean": 1.0, "std": 0.1}, "Re": (100, 400, 1000, 1600, 3200),
            "epochs": (10, 20, 50, 50, 500), **overrides}


def re3200_sota(**overrides) -> Dict:
    """``conf/ldc_2d_Re3200_sota.yaml``: ModifiedMLP 5 x 256."""
    return {**_COMMON, "arch": "modified_mlp", "num_layers": 5, "fourier": {"dim": 128, "scale": 10.0},
            "random_weight": {"mean": 1.0, "std": 0.1}, "Re": (100, 400, 1000, 3200), "epochs": (50, 50, 100, 500),
            "bs_pde": 8192, **overrides}


def re1000_plain(**overrides) -> Dict:
    """``conf/ldc_2d_Re1000_plain.yaml``: MLP 4 x 256, no embeddings."""
    return {**_COMMON, "arch": "mlp", "num_layers": 4, "fourier": None, "random_weight": None,
            "Re": (100, 400, 1000), "epochs": (20, 40, 140), "decay_steps": 2000, "warmup_epoch": 0,
            "init_weights": (1, 1, 1, 1, 1), **overrides}


RECIPES: Dict[str, Callable[..., Dict]] = {"re3200_piratenet": re3200_piratenet, "re3200_sota": re3200_sota,
                                           "re1000_plain": re1000_plain}


def lid_velocity(x: np.ndarray) -> np.ndarray:
    """The regularised lid profile."""
    return 1.0 - np.cosh(50.0 * (x - 0.5)) / np.cosh(25.0)


def boundary_points(n_per_side: int):
    """(points (4n, 2), u (4n, 1), v (4n, 1)) on the four walls, the lid
    first, float32 (the JAX recipe's points)."""
    t = np.linspace(0, 1, n_per_side, dtype=np.float32)
    te = np.linspace(0, 1 - 1e-6, n_per_side, dtype=np.float32)
    top = np.stack([t, np.ones_like(t)], 1)
    bottom = np.stack([t, np.zeros_like(t)], 1)
    left = np.stack([np.zeros_like(te), te], 1)
    right = np.stack([np.ones_like(te), te], 1)
    pts = np.concatenate([top, bottom, left, right], 0)
    u_bc = np.zeros((4 * n_per_side, 1), np.float32)
    u_bc[:n_per_side, 0] = lid_velocity(t)
    v_bc = np.zeros_like(u_bc)
    return pts, u_bc, v_bc


def make_model(cfg: Dict, device: DeviceLike = None):
    """The recipe's net, drawn from ``cfg["seed"]``."""
    common = dict(hidden_size=int(cfg["hidden_size"]), activation=cfg["activation"], fourier=cfg.get("fourier"),
                  random_weight=cfg.get("random_weight"), generator=torch.Generator().manual_seed(int(cfg["seed"])),
                  device=device)
    keys = (tuple(cfg["input_keys"]), tuple(cfg["output_keys"]))
    if cfg["arch"] == "piratenet":
        return PirateNet(*keys, num_blocks=int(cfg["num_blocks"]), **common)
    if cfg["arch"] == "modified_mlp":
        return ModifiedMLP(*keys, num_layers=int(cfg["num_layers"]), **common)
    if cfg["arch"] == "mlp":
        return MLP(*keys, num_layers=int(cfg["num_layers"]), **common)
    raise ValueError(f"arch '{cfg['arch']}' not found; available: piratenet, modified_mlp, mlp")


def make_training(cfg: Dict, model):
    """(optimizer, GradNorm) shared by every stage: Adam on one
    ExponentialDecay over the sum of the stages' epochs with the warmup."""
    lr = ExponentialDecay(epochs=sum(int(e) for e in cfg["epochs"]), iters_per_epoch=int(cfg["iters_per_epoch"]),
                          learning_rate=float(cfg["learning_rate"]), gamma=float(cfg["gamma"]),
                          decay_steps=int(cfg["decay_steps"]), warmup_epoch=int(cfg["warmup_epoch"]))()
    grad_norm = mtl.GradNorm(model, 5, int(cfg["update_freq"]), float(cfg["momentum"]),
                             init_weights=list(cfg["init_weights"]))
    return Adam(lr)(model), grad_norm


def build_stage_solver(cfg: Dict, model, optimizer, grad_norm, Re: float, epochs: int,
                       output_dir: Optional[str], device: DeviceLike = None) -> Solver:
    """The solver of one stage at ``Re`` for ``epochs`` epochs (the JAX
    ``build_stage_solver``); ``grad_norm`` None: the plain sum."""
    device = resolve_device(device)
    equation = {"NavierStokes": NavierStokes(1.0 / Re, 1.0, 2, False)}
    bs_pde = int(cfg["bs_pde"])

    def sample_fn(gen: torch.Generator):
        xy = torch.rand(bs_pde, 2, generator=gen, device=device)
        zeros = torch.zeros(bs_pde, 1, device=device)
        return ({"x": xy[:, 0:1], "y": xy[:, 1:2]},
                {"continuity": zeros, "momentum_x": zeros, "momentum_y": zeros}, {})

    pde = Constraint(DeviceSampledDataset(sample_fn), None, MSELoss("mean"), "PDE")
    pde.output_expr = equation["NavierStokes"].equations
    pde.output_keys = ("continuity", "momentum_x", "momentum_y")  # the order GradNorm's weights follow

    pts, u_bc, v_bc = boundary_points(int(cfg["bs_bc"]))
    bc = SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"x": pts[:, 0:1], "y": pts[:, 1:2]},
                     "label": {"u": u_bc, "v": v_bc}}},
        MSELoss("mean"), {"u": lambda out: out["u"], "v": lambda out: out["v"]}, name="BC")

    ref = ldc_reference.load_reference(Re, n=int(cfg["reference_n"]), cache_dir=cfg.get("reference_dir"),
                                       device=device)
    X, Y = np.meshgrid(ref["x"], ref["y"], indexing="ij")
    U_ref = np.sqrt(ref["u"] ** 2 + ref["v"] ** 2).reshape(-1, 1).astype(np.float32)
    validator = {"U_validator": SupervisedValidator(
        {"dataset": {"name": "NamedArrayDataset",
                     "input": {"x": X.reshape(-1, 1).astype(np.float32), "y": Y.reshape(-1, 1).astype(np.float32)},
                     "label": {"U": U_ref}},
         "batch_size": int(cfg["eval_batch"])},
        MSELoss("mean"), {"U": lambda out: (out["u"] ** 2 + out["v"] ** 2) ** 0.5},
        metric={"L2Rel": L2Rel()}, name="U_validator")}

    return Solver(model, {"PDE": pde, "BC": bc}, output_dir, optimizer, epochs=epochs,
                  iters_per_epoch=int(cfg["iters_per_epoch"]), equation=equation, validator=validator,
                  eval_during_train=bool(cfg["eval_during_train"]), eval_freq=int(cfg["eval_freq"]),
                  loss_aggregator=grad_norm, loss_granularity="key", log_freq=int(cfg["log_freq"]),
                  seed=int(cfg["seed"]), device=device)


def ghia_report(model, Re: float) -> Dict:
    """RMSE of the model's centreline profiles against the Ghia et al.
    (1982) tables, printed (Re 100 and 1000; else {})."""
    if int(Re) not in ghia.GHIA_TABLES:
        return {}
    device = next(model.parameters()).device

    @torch.no_grad()
    def uv_fn(x, y):
        col = lambda a: torch.as_tensor(np.asarray(a, np.float32).reshape(-1, 1), device=device)
        out = model({"x": col(x), "y": col(y)})
        return {"u": out["u"].cpu().numpy(), "v": out["v"].cpu().numpy()}

    r = ghia.profile_rmse(uv_fn, int(Re))
    print(f"Re={Re}: Ghia-profile RMSE u={r['ghia_u_rmse']:.4f} (n={r['n_u']}), v={r['ghia_v_rmse']:.4f} "
          f"(n={r['n_v']}) [vs Ghia et al. 1982 tables; regularized-lid caveat]", flush=True)
    return r


def train_curriculum(cfg: Dict, output_dir: Optional[str] = "./output_ldc", device: DeviceLike = None,
                     deriv: Optional[str] = None, num_fused_steps: Optional[int] = None) -> List[Dict]:
    """Train the curriculum of ``cfg`` stage by stage, each stage's solver
    starting from the previous one's state; after each stage evaluate
    L2Rel.U and print the Ghia RMSE. ``deriv`` names a derivative-path
    candidate to pin (None: none is pinned); ``num_fused_steps`` is passed
    to ``Solver.train``. Returns per stage {"Re", "epochs", "tf32" (whether
    the stage ran torch's matmuls in TF32), "metric",
    "ghia", "logs", "train_s" (the seconds of ``train()``), "graph_stats",
    "weights" (the GradNorm weights at the stage's end), "step" (the
    carried global step at its end)}."""
    device = resolve_device(device)
    if deriv is not None:
        deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    with stage_precision(False):  # restores the flags as they were, however the run ends
        return _train_stages(cfg, output_dir, device, num_fused_steps)


@contextlib.contextmanager
def stage_precision(tf32: bool):
    """Allow TF32 in torch's matmuls and cuDNN (``tf32``) or keep them in
    float32 inside the context; the flags as they were come back after
    it, on success and on failure alike."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _train_stages(cfg: Dict, output_dir, device, num_fused_steps) -> List[Dict]:
    model = make_model(cfg, device)
    optimizer, grad_norm = make_training(cfg, model)
    mixed = bool(cfg.get("mixed_curriculum_precision", False))
    carry, prev, results = None, None, []
    for idx, (Re, epochs) in enumerate(zip(cfg["Re"], cfg["epochs"])):
        # the warm-up stages in TF32 when mixed, the last Re (and every stage otherwise) in float32
        tf32 = mixed and idx < len(cfg["Re"]) - 1
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        out_dir = None if output_dir is None else os.path.join(output_dir, f"Re_{int(Re)}")
        print(f"Training curriculum {idx + 1}/{len(cfg['Re'])} Re={Re} epochs={epochs}", flush=True)
        solver = build_stage_solver(cfg, model, optimizer, grad_norm, float(Re), int(epochs), out_dir, device)
        if carry is not None:
            solver.state = carry
            prev.release_graphs()
        t0 = time.perf_counter()
        logs = solver.train(num_fused_steps)
        train_s = time.perf_counter() - t0
        metric, _ = solver.eval()
        print(f"Re={Re}: L2Rel.U = {metric:.5f}", flush=True)
        results.append({"Re": Re, "epochs": int(epochs), "tf32": tf32, "metric": metric,
                        "ghia": ghia_report(model, Re), "logs": logs, "train_s": train_s,
                        "graph_stats": dict(solver.graph_stats),
                        "weights": solver.agg_state["weight"].tolist(), "step": solver.step})
        carry, prev = solver.state, solver
    prev.release_graphs()
    return results


def evaluate(cfg: Dict, pretrained_model_path: Optional[str] = None, output_dir: Optional[str] = "./output_ldc",
             device: DeviceLike = None) -> float:
    """L2Rel.U at the last Re of ``cfg`` of a fresh model, or of the
    checkpoint at ``pretrained_model_path``."""
    device = resolve_device(device)
    model = make_model(cfg, device)
    solver = build_stage_solver(cfg, model, Adam(1e-3)(model), None, float(cfg["Re"][-1]), 1, output_dir, device)
    if pretrained_model_path:
        solver.load_pretrain(pretrained_model_path)
    metric, _ = solver.eval()
    print(f"eval L2Rel.U = {metric:.5f}", flush=True)
    return metric


if __name__ == "__main__":
    train_curriculum(RECIPES[sys.argv[1] if len(sys.argv) > 1 else "re3200_piratenet"]())
