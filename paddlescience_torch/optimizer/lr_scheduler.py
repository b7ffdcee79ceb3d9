"""Learning-rate schedules (counterpart of
``paddlescience_tpu/optimizer/lr_scheduler.py``). ``Scheduler(...)()``
returns a function ``lr(step) -> float`` of the global step."""

from __future__ import annotations

from typing import Callable

__all__ = ["ExponentialDecay"]


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

    def __call__(self) -> Callable[[int], float]:
        lr0, g, ds = self.learning_rate, self.gamma, self.decay_steps

        def sched(step: int) -> float:
            return lr0 * g ** (step / ds)

        return sched
