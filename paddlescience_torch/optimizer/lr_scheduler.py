"""Learning-rate schedules (counterpart of
``paddlescience_tpu/optimizer/lr_scheduler.py``). ``Scheduler(...)()``
returns a function ``lr(step)`` of the global step, in two forms: given a
Python int it returns a float (the eager form), given a float32 tensor
step counter it returns a float32 tensor on the counter's device,
computed in float32 as the JAX package does (the form a captured CUDA
graph evaluates each step).

Ported: ``Constant``, and ``Cosine``, ``Step`` and ``ExponentialDecay``
with the linear warmup and ``by_epoch`` clock of ``LRBase``. The other
schedulers are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

__all__ = ["LRBase", "Constant", "Cosine", "Step", "ExponentialDecay"]

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], Union[float, torch.Tensor]]


class LRBase:
    """Warmup and ``by_epoch`` plumbing: ``warmup_epoch`` epochs (or their
    steps) of a linear ramp from ``warmup_start_lr`` to ``learning_rate``,
    then the subclass's schedule on the clock rebased to the warmup's end.
    With ``by_epoch`` the schedule advances once per epoch."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, warmup_epoch: int,
                 warmup_start_lr: float, last_epoch: int, by_epoch: bool):
        if warmup_epoch >= epochs:
            warmup_epoch = epochs
        self.epochs = epochs
        self.iters_per_epoch = iters_per_epoch
        self.learning_rate = learning_rate
        self.warmup_epoch = warmup_epoch
        self.by_epoch = by_epoch
        self.warmup_steps = warmup_epoch if by_epoch else round(warmup_epoch * iters_per_epoch)
        self.warmup_start_lr = warmup_start_lr
        self.last_epoch = last_epoch

    def _t(self, step: Step) -> Step:
        """Schedule time: epochs if ``by_epoch`` else steps."""
        if not self.by_epoch:
            return step
        if isinstance(step, torch.Tensor):
            return torch.floor(step / self.iters_per_epoch)
        return step // self.iters_per_epoch

    def _wrap_warmup(self, base: Schedule) -> Schedule:
        if self.warmup_steps <= 0:
            return base
        ws, start, end = self.warmup_steps, self.warmup_start_lr, self.learning_rate
        shift = ws * self.iters_per_epoch if self.by_epoch else ws  # ws schedule units in steps

        def sched(step: Step):
            t = self._t(step)
            if isinstance(step, torch.Tensor):
                warm = start + (end - start) * torch.clamp(t / ws, max=1.0)
                return torch.where(t < ws, warm, base(torch.clamp(step - shift, min=0.0)))
            if t < ws:
                return start + (end - start) * min(t / ws, 1.0)
            return base(max(step - shift, 0))

        return sched

    def get_lr_fn(self) -> Schedule:
        raise NotImplementedError

    def __call__(self) -> Schedule:
        fn = self._wrap_warmup(self.get_lr_fn())
        fn.by_epoch = self.by_epoch
        return fn


class Constant:
    """A constant learning rate."""

    def __init__(self, learning_rate: float, last_epoch: int = -1):
        self.learning_rate = learning_rate

    def __call__(self) -> Schedule:
        lr = self.learning_rate

        def sched(step: Step):
            return torch.full_like(step, lr) if isinstance(step, torch.Tensor) else lr

        return sched


class Cosine(LRBase):
    """Cosine decay from ``learning_rate`` to ``eta_min`` over the steps (or
    epochs) after the warmup."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, eta_min: float = 0.0,
                 warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1,
                 by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, learning_rate, warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.T_max = (epochs - self.warmup_epoch) * (1 if by_epoch else iters_per_epoch)
        self.eta_min = eta_min

    def get_lr_fn(self) -> Schedule:
        lr0, eta_min, T = self.learning_rate, self.eta_min, max(self.T_max, 1)

        def sched(step: Step):
            t = self._t(step)
            if isinstance(step, torch.Tensor):
                return eta_min + 0.5 * (lr0 - eta_min) * (1 + torch.cos(math.pi * torch.clamp(t, 0, T) / T))
            return eta_min + 0.5 * (lr0 - eta_min) * (1 + math.cos(math.pi * min(max(t, 0), T) / T))

        return sched


class Step(LRBase):
    """lr0 * gamma ** (t // step_size), t in epochs with ``by_epoch`` (then
    ``step_size`` counts epochs), else in steps (``step_size`` epochs of
    ``iters_per_epoch`` steps)."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, step_size: int, gamma: float,
                 warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1, by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, learning_rate, warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.step_size = step_size if by_epoch else step_size * iters_per_epoch
        self.gamma = gamma

    def get_lr_fn(self) -> Schedule:
        lr0, g, ss = self.learning_rate, self.gamma, max(self.step_size, 1)

        def sched(step: Step):
            t = self._t(step)
            if isinstance(step, torch.Tensor):
                return lr0 * torch.pow(torch.full_like(step, g), torch.floor(t / ss))
            return lr0 * g ** (t // ss)

        return sched


class ExponentialDecay(LRBase):
    """lr0 * gamma ** (t / decay_steps), decaying smoothly every step (t in
    steps; with ``by_epoch`` t counts epochs and ``decay_steps`` is divided
    by ``iters_per_epoch``), after a linear warmup of ``warmup_epoch``
    epochs from ``warmup_start_lr`` (``LRBase``: the decay's clock starts
    when the warmup ends)."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, gamma: float,
                 decay_steps: int, warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1,
                 by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, learning_rate, warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.decay_steps = decay_steps / iters_per_epoch if by_epoch else decay_steps
        self.gamma = gamma

    def get_lr_fn(self) -> Schedule:
        lr0, g, ds = self.learning_rate, self.gamma, self.decay_steps

        def sched(step: Step):
            t = self._t(step)
            if isinstance(step, torch.Tensor):
                return lr0 * torch.pow(g, t / ds)
            return lr0 * g ** (t / ds)

        return sched
