"""hPINNs: holography inverse design with hard constraints, on the port
(counterpart of ``examples/hpinns.py``).

Three MLPs 15 -> 48 x 4 -> 1 (tanh) give E_re, E_im and the permittivity
eps from the hard-constraint features of a point (:func:`features`: six
periodic Fourier pairs in x, y and one pair in y); E gets the
zero-Dirichlet envelope in y and eps is squashed into [1, 12]
(:meth:`HPINN.fields`). The PML-Helmholtz residual
(:meth:`HPINN.residuals`) takes first and second derivatives along x and y
by nested ``torch.func.jvp`` of the batched fields, as the JAX example
nests ``jax.jvp`` (the features are a transform of the coordinates, so
the jet forward does not apply: no kernel runs here). The PML
coefficients are complex (``torch.complex64``) functions of the fixed
points, made once.

The loss is the augmented Lagrangian 0.5 mu |r|^2 + <lambda, r> plus the
objective: |E|^2 matches the indicator of [-0.5, 0.5] x [1, 2] on the
objective points. The outer loop updates the per-point multipliers
lambda += mu r and the penalty mu *= 2 after each inner loop but the last.
lambda and mu are device tensors updated in place, so the inner step,
captured once in a CUDA graph on the card (``utils/step_graph.py``), is
never recaptured. Adam at 1e-3 (optax's rule).

Run on the GPU: ``python -m paddlescience_torch.examples.hpinns [inner
steps]``.
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.utils.step_graph import StepGraph

__all__ = ["sample_points", "features", "HPINN", "build", "train", "DEFAULTS", "IN_KEYS"]

BOX = np.array([[-2.0, -2.0], [2.0, 3.0]])
DPML = 1.0
OMEGA = 2 * np.pi
SIGMA0 = -np.log(1e-20) / (4 * DPML**3 / 3)
L_BOX = BOX + np.array([[-DPML, -DPML], [DPML, DPML]])
BETA = 2.0
IN_KEYS = tuple(f"x_cos_{t}" for t in range(1, 7)) + tuple(f"x_sin_{t}" for t in range(1, 7)) + (
    "y", "y_cos_1", "y_sin_1")

# the JAX configuration (examples/conf/hpinns.yaml)
DEFAULTS = dict(num_layers=4, hidden_size=48, train_mode="aug_lag", epochs=4, iters_per_epoch=250,
                n_lagrangian_updates=4, learning_rate=1e-3, num_opt_points=1500, num_pde_points=5000)


def sample_points(n_obj=1500, n_pde=5000, seed=0):
    """The JAX example's points: the objective region's first, then the
    PDE points over the box with its PML."""
    rng = np.random.default_rng(seed)
    obj = np.stack([rng.uniform(-0.5, 0.5, n_obj), rng.uniform(1.0, 2.0, n_obj)], 1).astype(np.float32)
    pde = np.stack([rng.uniform(L_BOX[0][0], L_BOX[1][0], n_pde),
                    rng.uniform(L_BOX[0][1], L_BOX[1][1], n_pde)], 1).astype(np.float32)
    return np.concatenate([obj, pde], 0), n_obj


def features(xy: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The hard-constraint input transform of (N, 2) points: (N, 1) columns
    under ``IN_KEYS``."""
    x, y = xy[:, :1], xy[:, 1:]
    w = 2 * np.pi / (BOX[1][0] - BOX[0][0] + 2 * DPML)
    f = {}
    for t in range(1, 7):
        f[f"x_cos_{t}"] = torch.cos(t * w * x)
    for t in range(1, 7):
        f[f"x_sin_{t}"] = torch.sin(t * w * x)
    f["y"] = y
    f["y_cos_1"] = torch.cos(OMEGA * y)
    f["y_sin_1"] = torch.sin(OMEGA * y)
    return f


def _sigma1(d):
    return SIGMA0 * d**2 * (d > 0)


def _sigma2(d):
    return 2 * SIGMA0 * d * (d > 0)


def _pml_coefs(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The PML's complex coefficients at the points, as eight real parts."""
    sx = _sigma1(BOX[0][0] - x) + _sigma1(x - BOX[1][0])
    ab1 = 1.0 / (1 + 1j / OMEGA * sx) ** 2
    dsx = -_sigma2(BOX[0][0] - x) + _sigma2(x - BOX[1][0])
    ab2 = -1j / OMEGA * dsx * ab1 / (1 + 1j / OMEGA * sx)
    sy = _sigma1(BOX[0][1] - y) + _sigma1(y - BOX[1][1])
    ab3 = 1.0 / (1 + 1j / OMEGA * sy) ** 2
    dsy = -_sigma2(BOX[0][1] - y) + _sigma2(y - BOX[1][1])
    ab4 = -1j / OMEGA * dsy * ab3 / (1 + 1j / OMEGA * sy)
    return tuple(t for ab in (ab1, ab2, ab3, ab4) for t in (ab.real, ab.imag))


def _obj_j(y: torch.Tensor) -> torch.Tensor:
    h = 0.2
    yy = y + 1.5
    return 1 / (h * np.pi**0.5) * torch.exp(-((yy / h) ** 2)) * (torch.abs(yy) < 0.5)


class HPINN:
    """The three nets, the points, the multipliers and the step."""

    def __init__(self, cfg: Optional[Dict] = None, seed: int = 42, *, device: DeviceLike = None):
        c = dict(DEFAULTS, **(cfg or {}))
        self.cfg = c
        self.device = device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.nets = [MLP(IN_KEYS, (key,), c["num_layers"], c["hidden_size"], activation="tanh", generator=g,
                         device=device) for key in ("e_re", "e_im", "eps")]
        pts, self.bound = sample_points(c["num_opt_points"], c["num_pde_points"], seed=seed)
        self.xy = torch.from_numpy(pts).to(device)
        pde = self.xy[self.bound:]
        x, y = pde[:, 0], pde[:, 1]
        self.pml = _pml_coefs(x, y)
        self.in_slab = (y < 0) & (y > -1)
        self.obj_j = _obj_j(y)
        xo, yo = self.xy[: self.bound, 0], self.xy[: self.bound, 1]
        self.target = (((xo + 0.5) * (0.5 - xo) > 0).float() * ((yo - 1) * (2 - yo) > 0).float())
        n_pde = pde.shape[0]
        self.lam_re = torch.zeros(n_pde, device=device)
        self.lam_im = torch.zeros(n_pde, device=device)
        self.mu = torch.tensor(2.0, device=device)
        self.optimizer = Adam(c["learning_rate"])(*self.nets)
        me = weakref.proxy(self)  # the loop reaches its model weakly: dropping the model frees its graphs
        self.loop = StepGraph(lambda i: me._step(), device, state=lambda: me._state())

    def fields(self, xy: torch.Tensor) -> torch.Tensor:
        """(N, 2) points -> (N, 3): E_re and E_im with the zero-Dirichlet
        envelope in y, eps in [1, 12]."""
        f = features(xy)
        y = xy[:, 1]
        a_lo, b_hi = BOX[0][1] - DPML, BOX[1][1] + DPML
        env = (1 - torch.exp(a_lo - y)) * (1 - torch.exp(y - b_hi))
        e_re = env * self.nets[0](f)["e_re"][:, 0]
        e_im = env * self.nets[1](f)["e_im"][:, 0]
        eps = torch.sigmoid(self.nets[2](f)["eps"][:, 0]) * 11 + 1
        return torch.stack([e_re, e_im, eps], -1)

    def _derivs(self, xy: torch.Tensor, j: int):
        """d/dx_j and d^2/dx_j^2 of the fields at the (N, 2) points: nested
        forward-mode derivatives along coordinate j (each row its own
        point)."""
        tang = torch.zeros_like(xy)
        tang.select(-1, j).fill_(1.0)  # a kernel, no host copy: the step is captured
        d1 = lambda v: torch.func.jvp(self.fields, (v,), (tang,))[1]
        return torch.func.jvp(d1, (xy,), (tang,))

    def residuals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The PML-Helmholtz residual's real and imaginary parts at the PDE
        points."""
        xy = self.xy[self.bound:]
        flds = self.fields(xy)
        e_re, e_im = flds[:, 0], flds[:, 1]
        eps = torch.where(self.in_slab, flds[:, 2], torch.ones_like(flds[:, 2]))
        d_x, d_xx = self._derivs(xy, 0)
        d_y, d_yy = self._derivs(xy, 1)
        dre_x, dre_xx, dre_y, dre_yy = d_x[:, 0], d_xx[:, 0], d_y[:, 0], d_yy[:, 0]
        dim_x, dim_xx, dim_y, dim_yy = d_x[:, 1], d_xx[:, 1], d_y[:, 1], d_yy[:, 1]
        a1, b1, a2, b2, a3, b3, a4, b4 = self.pml
        loss_re = ((a1 * dre_xx + a2 * dre_x + a3 * dre_yy + a4 * dre_y) / OMEGA
                   - (b1 * dim_xx + b2 * dim_x + b3 * dim_yy + b4 * dim_y) / OMEGA
                   + eps * OMEGA * e_re)
        loss_im = ((a1 * dim_xx + a2 * dim_x + a3 * dim_yy + a4 * dim_y) / OMEGA
                   + (b1 * dre_xx + b2 * dre_x + b3 * dre_yy + b4 * dre_y) / OMEGA
                   + eps * OMEGA * e_im + self.obj_j)
        return loss_re, loss_im

    def loss(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, PDE MSE, objective)."""
        res_re, res_im = self.residuals()
        loss_eqs = torch.mean(res_re**2) + torch.mean(res_im**2)
        loss_lag = torch.mean(res_re * self.lam_re) + torch.mean(res_im * self.lam_im)
        e = self.fields(self.xy[: self.bound])
        jdiff = e[:, 0] ** 2 + e[:, 1] ** 2 - self.target
        loss_obj = torch.mean(jdiff**2)
        return 0.5 * self.mu * loss_eqs + loss_lag + loss_obj, loss_eqs, loss_obj

    def parameters(self) -> List[torch.Tensor]:
        return [p for net in self.nets for p in net.parameters()]

    def _state(self) -> List[torch.Tensor]:
        return self.parameters() + [t for s in self.optimizer.state_tensors().values() for t in s.values()]

    def _step(self) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad()
        loss, loss_eqs, loss_obj = self.loss()
        loss.backward()
        self.optimizer.step(0)  # a constant rate
        return {"loss": loss.detach(), "pde": loss_eqs.detach(), "obj": loss_obj.detach()}

    def train_steps(self, n: int, k: int = 1) -> Dict[str, float]:
        """``n`` inner steps in chunks of ``k`` (one graph replay each on
        CUDA when k > 1); returns the last step's logs."""
        if n % k:
            raise ValueError(f"{n} steps do not split into chunks of {k}")
        for _ in range(n // k):
            logs = self.loop.run(k, graphed=k > 1)
        return {n_: float(v) for n_, v in logs.items()}

    @torch.no_grad()
    def lagrangian_update(self) -> None:
        """lambda += mu r, mu *= beta, in place."""
        res_re, res_im = self.residuals()
        self.lam_re.add_(self.mu * res_re)
        self.lam_im.add_(self.mu * res_im)
        self.mu.mul_(BETA)

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """The PDE residual MSE and the objective at the current state."""
        res_re, res_im = self.residuals()
        _, _, loss_obj = self.loss()
        return {"pde_mse": float(torch.mean(res_re**2) + torch.mean(res_im**2)), "objective": float(loss_obj)}


def build(cfg: Optional[Dict] = None, seed: int = 42, *, device: DeviceLike = None) -> HPINN:
    return HPINN(cfg, seed, device=device)


def train(cfg: Optional[Dict] = None, seed: int = 42, k: Optional[int] = None, log_freq: int = 100, *,
          device: DeviceLike = None) -> Dict[str, float]:
    """The JAX ``train``: ``n_lagrangian_updates`` outer iterations (one in
    "soft" mode) of epochs x iters_per_epoch inner steps (chunks of ``k``,
    default the epoch's), a multiplier update between them; then the PDE
    MSE and the objective."""
    model = build(cfg, seed, device=device)
    c = model.cfg
    aug_lag = c["train_mode"] == "aug_lag"
    inner = c["iters_per_epoch"] * c["epochs"]
    outer = c["n_lagrangian_updates"] if aug_lag else 1
    k = k or c["iters_per_epoch"]
    for it in range(outer):
        for s in range(inner // k):
            logs = model.train_steps(k, k)
            g = it * inner + (s + 1) * k
            if g % max(log_freq, 1) == 0:
                print(f"[hpinns][{g}/{outer * inner}] loss={logs['loss']:.5f} pde={logs['pde']:.5f} "
                      f"obj={logs['obj']:.5f}", flush=True)
        if aug_lag and it < outer - 1:
            model.lagrangian_update()
            print(f"[hpinns] lagrangian update {it + 1}: mu -> {float(model.mu)}")
    out = model.evaluate()
    print(f"hPINNs final: pde residual MSE = {out['pde_mse']:.4e}, objective = {out['objective']:.4e}")
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    train(dict(epochs=1, iters_per_epoch=int(argv[0])) if argv else None)
