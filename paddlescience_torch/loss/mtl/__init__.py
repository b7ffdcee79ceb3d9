"""Multi-task loss aggregators (counterpart of
``paddlescience_tpu/loss/mtl/__init__.py``): ``Sum`` and ``GradNorm``.

An aggregator holds its state in a dict the solver keeps
(``init_state``); ``aggregate(losses, state)`` returns the total with the
weights detached. GradNorm's weights are refreshed by the solver every
``update_freq`` steps from per-loss gradient norms (``update_weights``)
and copied into the weight tensor it holds, the one a captured train step
reads.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["LossAggregator", "Sum", "GradNorm"]


class LossAggregator:
    """Plain sum with unit weights. ``model`` keeps the JAX signature
    (``GradNorm(model, n, ...)``); no aggregator of the port reads it."""

    needs_grad_norms: bool = False

    def __init__(self, model=None, num_losses: int = 1):
        self.model = model
        self.num_losses = num_losses

    def init_state(self, device: torch.device) -> Dict:
        return {}

    def aggregate(self, losses: Sequence[torch.Tensor], state: Dict):
        return torch.stack(list(losses)).sum(), state


class Sum(LossAggregator):
    """Unweighted sum."""


class GradNorm(LossAggregator):
    """Gradient-norm-ratio EMA weights: every ``update_freq`` steps
    w_i <- m * w_i + (1 - m) * mean(|g|) / |g_i|."""

    needs_grad_norms = True

    def __init__(self, model=None, num_losses: int = 1, update_freq: int = 1000, momentum: float = 0.9):
        super().__init__(model, num_losses)
        self.update_freq = update_freq
        self.momentum = momentum

    def init_state(self, device: torch.device) -> Dict:
        return {"weight": torch.ones(self.num_losses, device=device)}

    def update_weights(self, state: Dict, grad_norms: torch.Tensor) -> Dict:
        gn = torch.clamp(grad_norms, min=1e-12)
        new_w = gn.mean() / gn
        return {"weight": state["weight"] * self.momentum + new_w * (1 - self.momentum)}

    def aggregate(self, losses, state):
        return (state["weight"].detach() * torch.stack(list(losses))).sum(), state
