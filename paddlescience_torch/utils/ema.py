"""Weight averaging (counterpart of ``paddlescience_tpu/utils/ema.py``):
the averaged parameters live beside the parameters in the solver's state
and are updated in place inside each (captured) train step, after the
optimizer's update, at the step count after it; whether a step averages is
a ``torch.where`` on the device step, as the JAX solver's ``jnp.where``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ExponentialMovingAverage", "StochasticWeightAverage"]


class ExponentialMovingAverage:
    """shadow <- decay * shadow + (1 - decay) * params every ``avg_freq``
    steps."""

    kind = "ema"

    def __init__(self, model=None, decay: float = 0.9, avg_freq: int = 1):
        self.decay = decay
        self.avg_freq = avg_freq

    @torch.no_grad()
    def update_(self, avg: List[torch.Tensor], params: List[torch.Tensor], step: torch.Tensor) -> None:
        """Average ``params`` into ``avg`` in place at step ``step`` (a
        float32 tensor: the count of updates taken)."""
        take = torch.remainder(step, self.avg_freq) == 0
        for a, p in zip(avg, params):
            new = self.decay * a + (1.0 - self.decay) * p
            a.copy_(torch.where(take, new, a))


class StochasticWeightAverage:
    """The running mean of the parameters every ``avg_freq`` steps, within
    ``avg_range`` = (start, end) steps when given: shadow <- (shadow * n +
    params) / (n + 1), n = max((step - start) // avg_freq, 0)."""

    kind = "swa"

    def __init__(self, model=None, avg_freq: int = 1, avg_range: Optional[Tuple[int, int]] = None):
        self.avg_freq = avg_freq
        self.avg_range = avg_range

    @torch.no_grad()
    def update_(self, avg: List[torch.Tensor], params: List[torch.Tensor], step: torch.Tensor) -> None:
        take = torch.remainder(step, self.avg_freq) == 0
        start = 0
        if self.avg_range is not None:
            start, end = self.avg_range
            take = take & (step >= start) & (step <= end)
        n_avg = torch.clamp(torch.div(step - start, self.avg_freq, rounding_mode="floor"), min=0.0)
        for a, p in zip(avg, params):
            new = (a * n_avg + p) / (n_avg + 1.0)
            a.copy_(torch.where(take, new, a))
