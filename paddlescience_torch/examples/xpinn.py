"""XPINN: extended PINN with domain decomposition, on the port
(counterpart of ``examples/xpinn.py``).

Poisson's equation lap(u) = e^x + e^y (exact solution u = e^x + e^y) on
[-1, 1]^2, split into three strips at x = -1/3 and x = 1/3, one MLP 2 ->
20 x 4 -> 1 (tanh) a strip. The composite loss is the JAX example's:
boundary data on the outer square through the middle net (weight 20),
each net's PDE residual on its strip (weight 1), interface average
continuity (weight 20) and interface residual continuity (weight 1) on
both interfaces; Adam at 5e-4 (optax's rule); the score ``l2_rel`` over
the three strips' residual points. Points come from
:func:`sample_points`, the JAX example's numpy draw.

Each residual is one evaluation of the port's expression layer
(``utils/expression.py``): the Laplacian's second derivatives come from
the derivative tape (``autodiff/ad.py``: order <= 2 from the model's jet
forward) along the process's derivative path (``autodiff/path.py``), as
the ``Solver``'s constraints take theirs. On a kernel candidate pinned
whole (``jet_pallas_full``) each residual runs the MLP jet kernels once:
``jet_mlp_fwd``, then ``jet_mlp_bwd`` and ``jet_wgrad`` in the backward,
at 5 streams (u, u_x, u_y, u_xx, u_yy) over its rows. The JAX example
takes nested ``jax.jvp``; the ``jvp`` candidate is the same math here.

On CUDA, :meth:`XPINN.train` replays the step captured in a CUDA graph
(``utils/step_graph.py``), K steps a replay.

Run on the GPU: ``python -m paddlescience_torch.examples.xpinn [steps]``.
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.autodiff import ad
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.utils.expression import evaluate_expressions
from paddlescience_torch.utils.step_graph import StepGraph

__all__ = ["exact_u", "sample_points", "XPINN", "build", "train", "DEFAULTS"]

# the JAX configuration (examples/conf/xpinn.yaml)
DEFAULTS = dict(epochs=10, iters_per_epoch=50, learning_rate=5e-4, num_boundary_points=200,
                num_residual1_points=2000, num_residual2_points=900, num_residual3_points=900, num_interface=100)


def exact_u(x, y):
    return np.exp(x) + np.exp(y)


def sample_points(n_boundary=200, n_res=(2000, 900, 900), n_iface=100, seed=0):
    """The JAX example's points: the middle strip's residual points first,
    then the left and right strips', the outer boundary and the two
    interfaces (x = -1/3, x = 1/3), from one numpy generator."""
    rng = np.random.default_rng(seed)

    def in_strip(lo, hi, n):
        return np.stack([rng.uniform(lo, hi, n), rng.uniform(-1, 1, n)], 1).astype(np.float32)

    res1 = in_strip(-1 / 3, 1 / 3, n_res[0])
    res2 = in_strip(-1.0, -1 / 3, n_res[1])
    res3 = in_strip(1 / 3, 1.0, n_res[2])
    t = rng.uniform(-1, 1, n_boundary).astype(np.float32)
    side = rng.integers(0, 4, n_boundary)
    bx = np.where(side == 0, -1.0, np.where(side == 1, 1.0, t)).astype(np.float32)
    by = np.where(side == 2, -1.0, np.where(side == 3, 1.0, t)).astype(np.float32)
    boundary = np.stack([bx, by], 1)
    i1 = np.stack([np.full(n_iface, -1 / 3, np.float32), rng.uniform(-1, 1, n_iface).astype(np.float32)], 1)
    i2 = np.stack([np.full(n_iface, 1 / 3, np.float32), rng.uniform(-1, 1, n_iface).astype(np.float32)], 1)
    return boundary, (res1, res2, res3), (i1, i2)


def _poisson(out):
    """lap(u) - (e^x + e^y) on the tape."""
    lap = ad.unwrap(ad.hessian(out["u"], out["x"])) + ad.unwrap(ad.hessian(out["u"], out["y"]))
    return lap - (torch.exp(ad.unwrap(out["x"])) + torch.exp(ad.unwrap(out["y"])))


class XPINN:
    """The three nets, the points on the device, Adam and the step."""

    def __init__(self, cfg: Optional[Dict] = None, seed: int = 42, *, device: DeviceLike = None):
        c = dict(DEFAULTS, **(cfg or {}))
        self.cfg = c
        self.device = device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.nets = [MLP(("x", "y"), ("u",), 4, 20, activation="tanh", generator=g, device=device) for _ in range(3)]
        boundary, res, iface = sample_points(
            n_boundary=c["num_boundary_points"],
            n_res=(c["num_residual1_points"], c["num_residual2_points"], c["num_residual3_points"]),
            n_iface=c["num_interface"])
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.boundary = as_t(boundary)
        self.boundary_u = as_t(exact_u(boundary[:, :1], boundary[:, 1:]))
        self.res: List[torch.Tensor] = [as_t(r) for r in res]
        self.iface: List[torch.Tensor] = [as_t(i) for i in iface]
        self.optimizer = Adam(c["learning_rate"])(*self.nets)
        self._requests = [{} for _ in self.nets]  # each net's discovered jet requests
        self.step_count = 0
        me = weakref.proxy(self)  # the loop reaches its model weakly: dropping the model frees its graphs
        self.loop = StepGraph(lambda i: me._step(), device, state=lambda: me._state())

    def apply(self, k: int, xy: torch.Tensor) -> torch.Tensor:
        return self.nets[k]({"x": xy[:, :1], "y": xy[:, 1:]})["u"]

    def residual(self, k: int, xy: torch.Tensor) -> torch.Tensor:
        """Net k's Poisson residual on the (N, 2) points, as (N, 1)."""
        out = evaluate_expressions([self.nets[k]], {"x": xy[:, :1], "y": xy[:, 1:]}, {"r": _poisson},
                                   request_cache=self._requests[k])
        return out["r"]

    def loss(self) -> torch.Tensor:
        mse_u = 20.0 * torch.mean((self.apply(0, self.boundary) - self.boundary_u) ** 2)
        mse_f = sum(torch.mean(self.residual(k, self.res[k]) ** 2) for k in range(3))
        mse_avg = mse_r = 0.0
        for iface, k_nb in ((self.iface[0], 1), (self.iface[1], 2)):
            u1, un = self.apply(0, iface), self.apply(k_nb, iface)
            avg = (u1 + un) / 2.0
            mse_avg = mse_avg + 20.0 * torch.mean((u1 - avg) ** 2) + 20.0 * torch.mean((un - avg) ** 2)
            mse_r = mse_r + torch.mean((self.residual(0, iface) - self.residual(k_nb, iface)) ** 2)
        return mse_u + mse_f + mse_avg + mse_r

    def parameters(self) -> List[torch.Tensor]:
        return [p for net in self.nets for p in net.parameters()]

    def _state(self) -> List[torch.Tensor]:
        return self.parameters() + [t for s in self.optimizer.state_tensors().values() for t in s.values()]

    def _step(self) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad()
        loss = self.loss()
        loss.backward()
        self.optimizer.step(0)  # a constant rate
        return {"loss": loss.detach()}

    def train_steps(self, n: int, k: int = 1) -> float:
        """``n`` steps in chunks of ``k`` (one graph replay each on CUDA
        when k > 1); returns the last loss."""
        if n % k:
            raise ValueError(f"{n} steps do not split into chunks of {k}")
        for _ in range(n // k):
            logs = self.loop.run(k, graphed=k > 1)
        self.step_count += n
        return float(logs["loss"])

    def gradients(self) -> List[torch.Tensor]:
        """The loss and its gradient at the current parameters (no step)."""
        for p in self.parameters():
            p.grad = None
        loss = self.loss()
        grads = torch.autograd.grad(loss, self.parameters())
        return [loss.detach()] + [g.detach() for g in grads]

    @torch.no_grad()
    def l2_rel(self) -> float:
        preds, exacts = [], []
        for k in range(3):
            preds.append(self.apply(k, self.res[k]).cpu().numpy())
            xy = self.res[k].cpu().numpy()
            exacts.append(exact_u(xy[:, :1], xy[:, 1:]))
        p, e = np.concatenate(preds).ravel(), np.concatenate(exacts).ravel()
        return float(np.linalg.norm(e - p) / np.linalg.norm(e))


def build(cfg: Optional[Dict] = None, seed: int = 42, *, device: DeviceLike = None) -> XPINN:
    return XPINN(cfg, seed, device=device)


def train(cfg: Optional[Dict] = None, seed: int = 42, k: Optional[int] = None, log_freq: int = 100, *,
          device: DeviceLike = None) -> float:
    """The JAX ``train``: epochs x iters_per_epoch steps (chunks of ``k``,
    default the epoch's steps), then ``l2_rel``."""
    model = build(cfg, seed, device=device)
    c = model.cfg
    steps = c["epochs"] * c["iters_per_epoch"]
    k = k or c["iters_per_epoch"]
    for _ in range(steps // k):
        loss = model.train_steps(k, k)
        if model.step_count % max(log_freq, 1) == 0 or model.step_count == steps:
            print(f"[xpinn][{model.step_count}/{steps}] loss={loss:.5f}", flush=True)
    err = model.l2_rel()
    print(f"XPINN Poisson l2_error: {err:.4e}")
    return err


if __name__ == "__main__":
    argv = sys.argv[1:]
    cfg = dict(epochs=int(argv[0]) // DEFAULTS["iters_per_epoch"]) if argv else None
    train(cfg)
