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

CausalMSELoss(32 chunks, tol 1) (``loss="causal"``; ``"mse"``: a plain
MSE) on 4096 collocation points sampled on the device each step, plus the
initial-condition MSE on 512 points; GradNorm (update_freq 1000, momentum
0.9; ``aggregator="gradnorm"``), NTK (``"ntk"``: w_i = sum |g| / |g_i|
every update_freq steps) or the plain sum (``"sum"``); Adam with
ExponentialDecay (1e-3, gamma 0.9 every 2000 steps).

:data:`RECIPES` names the JAX example's six variants (its table and its
``conf/allen_cahn*.yaml`` numbers; ``recipe(name)`` gives the
:func:`build_solver` arguments):

============  ============  =============  ========  ======  ==========  ======  =====  =====
variant       arch          fourier scale  RWF mean  loss    aggregator  epochs  batch  decay
============  ============  =============  ========  ======  ==========  ======  =====  =====
default       mlp           1.0            0.5       causal  gradnorm    200     4096   2000
causal        mlp           1.0            0.5       causal  sum         200     4096   2000
plain         mlp           1.0            0.5       mse     sum         200     4096   2000
default_ntk   mlp           2.0            1.0       causal  ntk         200     4096   2000
sota          modified_mlp  2.0            1.0       causal  ntk         300     8192   5000
piratenet     piratenet     2.0            1.0       causal  gradnorm    300     8192   5000
============  ============  =============  ========  ======  ==========  ======  =====  =====

Every variant keeps eps = 0.01 (the JAX example's choice: the upstream
ntk and sota scripts pass 0.01**2).

No derivative path is pinned unless ``deriv`` names one, as in the JAX
example: under the process default the gated stacks run
their hidden layers as fused jet segments (CUDA kernels on the GPU) and
the MLP takes the plain jet path, and a long ``train()`` times the
candidates first (``solver/autotune.py``). ``Solver.train()`` runs whole
epochs as one chunk of steps each, a CUDA graph replay on the GPU.

The reference solution is the JAX example's: a Fourier pseudo-spectral
ETDRK4 solve on 512 points x 201 times (:func:`solve_allen_cahn_spectral`,
a numpy copy), cached in an ``.npz`` file. The ``u_validator`` holds the
model against it (L2Rel, in batches of 16384; the loader drops the short
last batch as the JAX package's does, so 6 batches, the first 192 of the
201 time rows). The initial-condition labels are row 0 of that solution.

Run on the GPU (train, then eval against the reference):
``python -m paddlescience_torch.examples.allen_cahn [variant] [epochs] [iters_per_epoch]``
(variant: a name of :data:`RECIPES`, default ``default``; epochs and
iterations: the variant's).
"""

from __future__ import annotations

import os
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
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "ic_data", "solve_allen_cahn_spectral", "get_reference_solution", "train", "evaluate",
           "recipe", "RECIPES", "REFERENCE_PATH"]

REFERENCE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                              "dataset", "allen_cahn_ref.npz")


def solve_allen_cahn_spectral(nx: int = 512, nt: int = 201, t_max: float = 1.0, eps2: float = 1e-4):
    """Reference solution by Fourier pseudo-spectral ETDRK4 (the Kassam and
    Trefethen 2005 scheme), periodic on [-1, 1], time step 1e-4; returns
    (t (nt,), x (nx,), u (nt, nx)) in float32. A copy of the JAX example's
    solver: the same numpy operations in the same order."""
    L = 2.0
    x = np.linspace(-1, 1, nx, endpoint=False)
    u = (x**2) * np.cos(np.pi * x)
    k = 2 * np.pi * np.fft.fftfreq(nx, d=L / nx)  # wavenumbers

    lin = -eps2 * k**2 + 5.0  # linear operator in Fourier space (from +5u)
    dt = 1e-4
    steps_total = int(round(t_max / dt))
    save_every = max(steps_total // (nt - 1), 1)

    E = np.exp(dt * lin)
    E2 = np.exp(dt * lin / 2)
    M = 32  # quadrature points on the unit circle for the phi functions
    r = np.exp(1j * np.pi * (np.arange(1, M + 1) - 0.5) / M)
    LR = dt * lin[:, None] + r[None, :]
    Q = dt * np.real(np.mean((np.exp(LR / 2) - 1) / LR, axis=1))
    f1 = dt * np.real(np.mean((-4 - LR + np.exp(LR) * (4 - 3 * LR + LR**2)) / LR**3, axis=1))
    f2 = dt * np.real(np.mean((2 + LR + np.exp(LR) * (-2 + LR)) / LR**3, axis=1))
    f3 = dt * np.real(np.mean((-4 - 3 * LR - LR**2 + np.exp(LR) * (4 - LR)) / LR**3, axis=1))

    def N_of(v_hat):
        v = np.real(np.fft.ifft(v_hat))
        return np.fft.fft(-5.0 * v**3)

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
    t = np.linspace(0, t_max, nt)
    return t.astype(np.float32), x.astype(np.float32), np.stack(out).astype(np.float32)


def get_reference_solution(cache_path: Optional[str] = None):
    """(t, x, u) of :func:`solve_allen_cahn_spectral` at its defaults, read
    from the ``.npz`` cache at ``cache_path`` (default
    :data:`REFERENCE_PATH`, the repository's ``dataset/``) or solved (about
    3 s) and written there."""
    cache_path = REFERENCE_PATH if cache_path is None else cache_path
    if os.path.exists(cache_path):
        d = np.load(cache_path)
        return d["t"], d["x"], d["usol"]
    t, x, usol = solve_allen_cahn_spectral()
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, t=t, x=x, usol=usol)
    os.replace(tmp, cache_path)  # whole, for a concurrent reader
    return t, x, usol


def ic_data(nx: int = 512):
    """(t, x, u0) columns of the initial condition, float32: row 0 of
    :func:`solve_allen_cahn_spectral` at ``nx`` points (bitwise; its
    initial state x^2 cos(pi x) on ``linspace(-1, 1, nx, endpoint=False)``)."""
    x = np.linspace(-1, 1, nx, endpoint=False)
    u0 = (x**2) * np.cos(np.pi * x)
    col = lambda a: a.astype(np.float32).reshape(-1, 1)
    return col(np.zeros_like(x)), col(x), col(u0)


# the JAX example's variants (examples/allen_cahn.py:107-116 and conf/allen_cahn*.yaml)
_GATED = dict(fourier_scale=2.0, rwf_mean=1.0, epochs=300, batch_size=8192, decay_steps=5000)
RECIPES = {
    "default": dict(arch="mlp", loss="causal", aggregator="gradnorm"),
    "causal": dict(arch="mlp", loss="causal", aggregator="sum"),
    "plain": dict(arch="mlp", loss="mse", aggregator="sum"),
    "default_ntk": dict(arch="mlp", fourier_scale=2.0, rwf_mean=1.0, loss="causal", aggregator="ntk"),
    "sota": dict(arch="modified_mlp", loss="causal", aggregator="ntk", **_GATED),
    "piratenet": dict(arch="piratenet", piratenet_blocks=3, loss="causal", aggregator="gradnorm", **_GATED),
}


def recipe(name: str, **overrides) -> dict:
    """The :func:`build_solver` arguments of variant ``name`` of
    :data:`RECIPES`, updated with ``overrides``."""
    if name not in RECIPES:
        raise ValueError(f"variant '{name}' not found; available: {', '.join(RECIPES)}")
    return {**RECIPES[name], **overrides}


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
    deriv: Optional[str] = None,
    device: DeviceLike = None,
    arch: str = "mlp",
    piratenet_blocks: int = 3,
    fourier_scale: Optional[float] = None,
    rwf_mean: Optional[float] = None,
    loss: str = "causal",
    aggregator: str = "gradnorm",
    output_dir: Optional[str] = "./output_allen_cahn",
    eval_during_train: bool = True,
    with_validator: bool = True,
    eval_freq: int = 10,
    checkpoint_path: Optional[str] = None,
    reference_path: Optional[str] = None,
) -> Solver:
    """The Allen-Cahn solver with backbone ``arch`` ("mlp", "modified_mlp"
    or "piratenet"); sizes are knobs so tests can shrink it. ``deriv``
    names a derivative-path candidate to pin (None: none is pinned).
    ``fourier_scale`` and ``rwf_mean`` default per arch (2.0 and 1.0 for
    the gated archs, 1.0 and 0.5 for the MLP). ``loss`` ("causal" or
    "mse") is the PDE loss, ``aggregator`` ("gradnorm", "ntk" or "sum")
    combines it with the IC loss (GradNorm and NTK refreshed every
    ``update_freq`` steps). With ``with_validator`` the
    solver holds the ``u_validator`` against the reference solution (read
    from or written to ``reference_path``, see
    :func:`get_reference_solution`), evaluated every ``eval_freq`` epochs
    under ``eval_during_train``; checkpoints go under ``output_dir``;
    ``checkpoint_path`` resumes from one."""
    device = resolve_device(device)
    if arch not in ("mlp", "modified_mlp", "piratenet"):
        raise ValueError(f"arch '{arch}' not found; available: mlp, modified_mlp, piratenet")
    if loss not in ("causal", "mse"):
        raise ValueError(f"loss '{loss}' not found; available: causal, mse")
    if aggregator not in ("gradnorm", "ntk", "sum"):
        raise ValueError(f"aggregator '{aggregator}' not found; available: gradnorm, ntk, sum")
    if deriv is not None:
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

    pde_loss = CausalMSELoss(32, "mean", tol=1.0) if loss == "causal" else MSELoss("mean")
    pde = Constraint(DeviceSampledDataset(sample_fn), None, pde_loss, "PDE")
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
    validator = None
    if with_validator:
        t_star, x_star, u_ref = get_reference_solution(reference_path)
        tt, xx = np.meshgrid(t_star, x_star, indexing="ij")  # row-major over (t, x), as cartesian_product
        validator = {"u_validator": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset",
                         "input": {"t": tt.reshape(-1, 1), "x": xx.reshape(-1, 1)},
                         "label": {"u": u_ref.reshape(-1, 1)}},
             "batch_size": 16384},
            MSELoss("mean"), {"u": lambda out: out["u"]}, metric={"L2Rel": L2Rel()}, name="u_validator")}
    return Solver(
        model, constraint, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
        log_freq=log_freq, eval_during_train=eval_during_train, eval_freq=eval_freq, seed=seed, equation=equation,
        validator=validator, checkpoint_path=checkpoint_path,
        loss_aggregator={"gradnorm": lambda: mtl.GradNorm(model, len(constraint), update_freq, 0.9),
                         "ntk": lambda: mtl.NTK(model, len(constraint), update_freq),
                         "sum": lambda: mtl.Sum(model, len(constraint))}[aggregator](), device=device,
    )


def train(**kwargs) -> float:
    """Train a :func:`build_solver` solver (``kwargs`` are its arguments),
    evaluate it, print the final and the best L2Rel against the reference
    as the JAX example does, and return the smaller."""
    solver = build_solver(**kwargs)
    solver.train()
    metric, _ = solver.eval()
    print(f"final L2Rel.u = {metric:.4e}")
    best = solver.best_metric.get("metric", float("inf"))
    if best < float("inf"):
        print(f"best  L2Rel.u = {best:.4e} @ epoch {solver.best_metric['epoch']}")
        metric = min(metric, best)
    return metric


def evaluate(pretrained_model_path: Optional[str] = None, **kwargs) -> float:
    """L2Rel of a :func:`build_solver` model against the reference, with
    the parameters of the checkpoint at ``pretrained_model_path`` if given."""
    solver = build_solver(eval_during_train=False, **kwargs)
    if pretrained_model_path:
        solver.load_pretrain(pretrained_model_path)
    metric, _ = solver.eval()
    print(f"eval L2Rel.u = {metric:.4e}")
    return metric


if __name__ == "__main__":
    argv = sys.argv[1:]
    kwargs = recipe(argv[0] if argv else "default")
    if len(argv) > 1:
        kwargs["epochs"] = int(argv[1])
    if len(argv) > 2:
        kwargs["iters_per_epoch"] = int(argv[2])
    train(**kwargs)
