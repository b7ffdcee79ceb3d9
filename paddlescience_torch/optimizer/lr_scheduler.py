"""Learning-rate schedules (counterpart of
``paddlescience_tpu/optimizer/lr_scheduler.py``). ``Scheduler(...)()``
returns a function ``lr(step)`` of the global step, in two forms: given a
Python int it returns a float (the eager form), given a float32 tensor
step counter it returns a float32 tensor on the counter's device,
computed in float32 as optax does (the form a captured CUDA graph
evaluates each step)."""

from __future__ import annotations

from typing import Callable, Union

import torch

__all__ = ["ExponentialDecay"]

Step = Union[int, torch.Tensor]


class ExponentialDecay:
    """lr0 * gamma ** (step / decay_steps), decaying smoothly every step.
    ``epochs`` and ``iters_per_epoch`` keep the JAX signature; the JAX
    package's per-epoch decay and warmup are not ported."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, gamma: float,
                 decay_steps: int):
        self.epochs = epochs
        self.iters_per_epoch = iters_per_epoch
        self.learning_rate = learning_rate
        self.gamma = gamma
        self.decay_steps = decay_steps

    def __call__(self) -> Callable[[Step], Union[float, torch.Tensor]]:
        lr0, g, ds = self.learning_rate, self.gamma, self.decay_steps

        def sched(step: Step):
            if isinstance(step, torch.Tensor):
                return lr0 * torch.pow(g, step / ds)
            return lr0 * g ** (step / ds)

        return sched
