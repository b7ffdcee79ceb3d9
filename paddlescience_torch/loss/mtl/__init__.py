"""Multi-task loss aggregators (counterpart of
``paddlescience_tpu/loss/mtl/__init__.py``): ``Sum``, ``GradNorm``,
``NTK``, ``Relobralo``, ``PCGrad``, ``AGDA`` and ``build_mtl_aggregator``.

An aggregator holds its state in a dict of device tensors the solver keeps
(``init_state``); ``aggregate(losses, state, step, generator)`` returns the
total with the weights detached, and an aggregator whose state moves each
step (Relobralo) writes it in place, so a captured train step updates it.
GradNorm's and NTK's weights are refreshed by the solver every
``update_freq`` steps from per-loss gradient norms (``update_weights``) and
copied into the weight tensor it holds, the one a captured train step
reads. The gradient-surgery aggregators (PCGrad, AGDA) set ``needs_grads``:
the solver then takes one backward per loss into flat gradient vectors
(K, P) and writes ``transform_grads`` of them into the parameters'
gradients, logging the plain sum of the losses as the total.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["LossAggregator", "Sum", "GradNorm", "NTK", "Relobralo", "PCGrad", "AGDA", "build_mtl_aggregator"]


class LossAggregator:
    """Plain sum with unit weights. ``model`` keeps the JAX signature
    (``GradNorm(model, n, ...)``); no aggregator of the port reads it."""

    needs_grad_norms: bool = False
    needs_grads: bool = False

    def __init__(self, model=None, num_losses: int = 1):
        self.model = model
        self.num_losses = num_losses

    def init_state(self, device: torch.device) -> Dict:
        return {}

    def aggregate(self, losses: Sequence[torch.Tensor], state: Dict, step: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        return torch.stack(list(losses)).sum(), state


class Sum(LossAggregator):
    """Unweighted sum."""


class _Weighted(LossAggregator):
    """A weight per loss, refreshed from per-loss gradient norms every
    ``update_freq`` steps; the total is the weighted sum, weights detached."""

    needs_grad_norms = True

    def __init__(self, model=None, num_losses: int = 1, update_freq: int = 1000):
        super().__init__(model, num_losses)
        self.update_freq = update_freq

    def init_state(self, device: torch.device) -> Dict:
        return {"weight": torch.ones(self.num_losses, device=device)}

    def aggregate(self, losses, state, step=None, generator=None):
        return (state["weight"].detach() * torch.stack(list(losses))).sum(), state


class GradNorm(_Weighted):
    """Gradient-norm-ratio EMA weights: every ``update_freq`` steps
    w_i <- m * w_i + (1 - m) * mean(|g|) / |g_i|, from ``init_weights``
    (one per loss; ones when None)."""

    def __init__(self, model=None, num_losses: int = 1, update_freq: int = 1000, momentum: float = 0.9,
                 init_weights: Optional[List[float]] = None):
        super().__init__(model, num_losses, update_freq)
        self.momentum = momentum
        if init_weights is not None and num_losses != len(init_weights):
            raise ValueError(
                f"Length of init_weights({len(init_weights)}) should be equal to num_losses({num_losses})."
            )
        self.init_weights = init_weights

    def init_state(self, device: torch.device) -> Dict:
        if not self.init_weights:
            return super().init_state(device)
        return {"weight": torch.tensor(self.init_weights, dtype=torch.float32, device=device)}

    def update_weights(self, state: Dict, grad_norms: torch.Tensor) -> Dict:
        gn = torch.clamp(grad_norms, min=1e-12)
        new_w = gn.mean() / gn
        return {"weight": state["weight"] * self.momentum + new_w * (1 - self.momentum)}


class NTK(_Weighted):
    """NTK-trace-ratio weights: every ``update_freq`` steps
    w_i = sum(|g|) / |g_i|, no EMA (so the weights are sums of norms over
    one norm, not near 1)."""

    def update_weights(self, state: Dict, grad_norms: torch.Tensor) -> Dict:
        gn = torch.clamp(grad_norms, min=1e-12)
        return {"weight": gn.sum() / gn}


class Relobralo(LossAggregator):
    """Relative loss balancing with random lookback (arXiv:2110.09813), as
    the JAX class: at step 0 the weights are 1 and both reference losses
    this step's; later, with rho ~ Bernoulli(beta),

        lmbda = alpha (rho lmbda + (1 - rho) bal(L, L_init)) + (1 - alpha) bal(L, L_prev),
        bal(a, b) = n softmax(a / (tau b + eps)),

    and L_prev <- L. The three state vectors live on the device and are
    written in place; the step-0 branch is a ``torch.where`` on the device
    step; rho is drawn from ``generator`` (the solver's, on its device), as
    the JAX solver draws it from its step key (threefry, which the port does
    not reproduce: the same rho sequence gives the same weights)."""

    def __init__(self, model=None, num_losses: int = 1, alpha: float = 0.95, beta: float = 0.99, tau: float = 1.0,
                 eps: float = 1e-8):
        super().__init__(model, num_losses)
        self.alpha = alpha
        self.beta = beta
        self.tau = tau
        self.eps = eps

    def init_state(self, device: torch.device) -> Dict:
        return {"losses_init": torch.zeros(self.num_losses, device=device),
                "losses_prev": torch.zeros(self.num_losses, device=device),
                "lmbda": torch.ones(self.num_losses, device=device)}

    def _bal(self, l1, l2):
        return self.num_losses * torch.softmax(l1 / (self.tau * l2 + self.eps), dim=0)

    def rho(self, step: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The lookback draw, 1 with probability beta (1 without a
        generator, as the JAX class without a key)."""
        if generator is None:
            return torch.ones((), device=step.device)
        u = torch.rand((), generator=generator, device=generator.device)
        return (u < self.beta).to(torch.float32)

    def aggregate(self, losses, state, step=None, generator=None):
        if step is None:
            raise ValueError("Relobralo needs the step counter")
        stacked = torch.stack(list(losses))
        vec = stacked.detach()
        rho = self.rho(step, generator)
        hist = rho * state["lmbda"] + (1 - rho) * self._bal(vec, state["losses_init"])
        later = self.alpha * hist + (1 - self.alpha) * self._bal(vec, state["losses_prev"])
        first = step == 0
        lmbda = torch.where(first, torch.ones_like(later), later)
        with torch.no_grad():
            state["losses_init"].copy_(torch.where(first, vec, state["losses_init"]))
            state["losses_prev"].copy_(vec)
            state["lmbda"].copy_(lmbda)
        return (lmbda.detach() * stacked).sum(), state


class PCGrad(LossAggregator):
    """Projected conflicting gradients (arXiv:2001.06782): each loss's
    gradient g_i is projected off every other g_j it conflicts with
    (g_i . g_j < 0), g <- g - (g . g_j) / (|g_j|^2 + 1e-12) g_j, the others
    taken in index order (as the JAX code does: its docstring's "random
    order" is not what it runs); the merged gradient is the sum."""

    needs_grads = True

    def transform_grads(self, G: torch.Tensor, state: Dict):
        """``G``: (K, P) flat per-loss gradients -> the merged (P,)."""
        K = G.shape[0]
        projected = []
        for i in range(K):
            g = G[i]
            for j in range(K):
                if j == i:
                    continue
                gj = G[j]
                dot = torch.dot(g, gj)
                coef = torch.where(dot < 0, dot / (torch.dot(gj, gj) + 1e-12), torch.zeros_like(dot))
                g = g - coef * gj
            projected.append(g)
        return torch.stack(projected).sum(dim=0), state


class AGDA(LossAggregator):
    """Gradient balancing as the JAX class: each loss's gradient scaled to
    the mean of the gradients' norms (g_i / (|g_i| + 1e-12) * mean |g|),
    then summed."""

    needs_grads = True

    def transform_grads(self, G: torch.Tensor, state: Dict):
        norms = torch.linalg.vector_norm(G, dim=1, keepdim=True) + 1e-12
        return (G / norms * norms.mean()).sum(dim=0), state


def build_mtl_aggregator(cfg, model=None) -> LossAggregator:
    """An aggregator from ``{"name": <class>, **kwargs}``."""
    import copy

    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name")
    cls = globals().get(name)
    if not (isinstance(cls, type) and issubclass(cls, LossAggregator)):
        raise ValueError(f"unknown loss aggregator '{name}'")
    return cls(model, **cfg)
