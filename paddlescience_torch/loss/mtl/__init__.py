"""Multi-task loss aggregators (counterpart of
``paddlescience_tpu/loss/mtl/__init__.py``): ``Sum``, ``GradNorm`` and
``NTK``.

An aggregator holds its state in a dict the solver keeps
(``init_state``); ``aggregate(losses, state)`` returns the total with the
weights detached. GradNorm's and NTK's weights are refreshed by the solver
every ``update_freq`` steps from per-loss gradient norms
(``update_weights``) and copied into the weight tensor it holds, the one a
captured train step reads.

Not ported yet: Relobralo, PCGrad and AGDA.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["LossAggregator", "Sum", "GradNorm", "NTK"]


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


class _Weighted(LossAggregator):
    """A weight per loss, refreshed from per-loss gradient norms every
    ``update_freq`` steps; the total is the weighted sum, weights detached."""

    needs_grad_norms = True

    def __init__(self, model=None, num_losses: int = 1, update_freq: int = 1000):
        super().__init__(model, num_losses)
        self.update_freq = update_freq

    def init_state(self, device: torch.device) -> Dict:
        return {"weight": torch.ones(self.num_losses, device=device)}

    def aggregate(self, losses, state):
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
