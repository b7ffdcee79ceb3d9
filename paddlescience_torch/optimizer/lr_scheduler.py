"""Learning-rate schedules (counterpart of
``paddlescience_tpu/optimizer/lr_scheduler.py``). ``Scheduler(...)()``
returns a function ``lr(step)`` of the global step, in two forms: given a
Python int it returns a float (the eager form), given a float32 tensor
step counter it returns a float32 tensor on the counter's device,
computed in float32 as the JAX package does (the form a captured CUDA
graph evaluates each step).

Every schedule of the JAX package: ``Constant``; ``Linear``, ``Cosine``,
``Step``, ``Piecewise``, ``MultiStepDecay``, ``ExponentialDecay``,
``CosineWarmRestarts``, ``OneCycleLR`` and ``LambdaDecay`` with the linear
warmup and ``by_epoch`` clock of ``LRBase``; ``SchedulerList``. The
tensor forms hold no host value and branch on no tensor (boundaries and
table values are Python numbers, a lookup a chain of ``torch.where``), so
a CUDA graph captures them.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import torch

__all__ = ["LRBase", "Constant", "Linear", "Cosine", "Step", "Piecewise", "MultiStepDecay", "ExponentialDecay",
           "CosineWarmRestarts", "CosineAnnealingWarmRestarts", "OneCycleLR", "LambdaDecay", "SchedulerList"]

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


def _count_reached(t, marks: Sequence[float]):
    """How many of ``marks`` the clock ``t`` has reached (t >= mark): a
    float32 tensor for a tensor clock (the comparisons in float32), else an
    int."""
    if isinstance(t, torch.Tensor):
        count = torch.zeros_like(t)
        for m in marks:
            count = count + (t >= m).to(t.dtype)
        return count
    return sum(1 for m in marks if t >= m)


class Linear(LRBase):
    """(lr0 - end_lr) * (1 - t / T) ** power + end_lr, t clipped to the
    decay's T steps (or epochs) after the warmup."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, end_lr: float = 0.0,
                 power: float = 1.0, cycle: bool = False, warmup_epoch: int = 0, warmup_start_lr: float = 0.0,
                 last_epoch: int = -1, by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, learning_rate, warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.decay_steps = (epochs - self.warmup_epoch) * (1 if by_epoch else iters_per_epoch)
        self.end_lr = end_lr
        self.power = power

    def get_lr_fn(self) -> Schedule:
        lr0, end_lr, power, ds = self.learning_rate, self.end_lr, self.power, max(self.decay_steps, 1)

        def sched(step: Step):
            t = self._t(step)
            t = torch.clamp(t, max=float(ds)) if isinstance(t, torch.Tensor) else min(t, ds)
            return (lr0 - end_lr) * (1 - t / ds) ** power + end_lr

        return sched


class Piecewise(LRBase):
    """``values[i]`` once the clock has reached ``i`` of the boundaries
    ``decay_epochs`` (epochs, or their steps; counted as t >= boundary, in
    float32 on a tensor clock), the last value past them all."""

    def __init__(self, iters_per_epoch: int, decay_epochs: Sequence[int], values: Sequence[float],
                 warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1, by_epoch: bool = False,
                 epochs: Optional[int] = None):
        epochs = epochs if epochs is not None else (max(decay_epochs) + 1 if decay_epochs else 1)
        super().__init__(epochs, iters_per_epoch, values[0], warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.boundaries = [e if by_epoch else e * iters_per_epoch for e in decay_epochs]
        self.values = [float(v) for v in values]

    def get_lr_fn(self) -> Schedule:
        bounds, vals = list(self.boundaries), list(self.values)
        last = len(vals) - 1

        def sched(step: Step):
            idx = _count_reached(self._t(step), bounds)
            if isinstance(idx, torch.Tensor):
                lr = torch.full_like(idx, vals[0])
                for i in range(1, len(vals)):
                    lr = torch.where(idx >= i, torch.full_like(idx, vals[i]), lr)
                return lr
            return vals[min(idx, last)]

        return sched


class MultiStepDecay(LRBase):
    """lr0 * gamma ** (the milestones the clock has reached); milestones in
    epochs (or their steps)."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, milestones: Sequence[int],
                 gamma: float = 0.1, warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1,
                 by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, learning_rate, warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.milestones = [m if by_epoch else m * iters_per_epoch for m in milestones]
        self.gamma = gamma

    def get_lr_fn(self) -> Schedule:
        ms, lr0, g = list(self.milestones), self.learning_rate, self.gamma

        def sched(step: Step):
            n = _count_reached(self._t(step), ms)
            if isinstance(n, torch.Tensor):
                return lr0 * torch.pow(torch.full_like(n, g), n)
            return lr0 * g**n

        return sched


class CosineWarmRestarts(LRBase):
    """SGDR: cosine annealing from ``learning_rate`` to ``eta_min`` over
    periods of ``T_0`` epochs (or their steps), each ``T_mult`` times the
    one before (the restart index in closed form, as in the JAX
    package)."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, T_0: int, T_mult: int = 1,
                 eta_min: float = 0.0, warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1,
                 by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, learning_rate, warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.T_0 = T_0 if by_epoch else T_0 * iters_per_epoch
        self.T_mult = T_mult
        self.eta_min = eta_min

    def get_lr_fn(self) -> Schedule:
        lr0, eta_min, T0, mult = self.learning_rate, self.eta_min, max(self.T_0, 1), self.T_mult

        def sched(step: Step):
            t = self._t(step)
            tensor = isinstance(t, torch.Tensor)
            t = t if tensor else float(t)
            if mult == 1:
                t_cur, T_i = (torch.remainder(t, T0) if tensor else math.fmod(t, T0)), T0
            else:
                log = torch.log if tensor else math.log
                floor = torch.floor if tensor else math.floor
                n = floor(log(t / T0 * (mult - 1) + 1) / math.log(mult))
                power = torch.pow(torch.full_like(n, float(mult)), n) if tensor else mult**n
                start = T0 * (power - 1) / (mult - 1)
                T_i = T0 * power
                t_cur = t - start
            cos = torch.cos if tensor else math.cos
            return eta_min + 0.5 * (lr0 - eta_min) * (1 + cos(math.pi * t_cur / T_i))

        return sched


CosineAnnealingWarmRestarts = CosineWarmRestarts


class OneCycleLR(LRBase):
    """The one-cycle policy: from max_lr / divide_factor up to
    ``max_learning_rate`` over the first ``phase_pct`` of the steps (or
    epochs), then down to ``end_learning_rate``, both by cosine
    (``anneal_strategy="cos"``; the ramp up written as the JAX package
    writes it, anneal(1 - frac, max, initial)) or linearly."""

    def __init__(self, epochs: int, iters_per_epoch: int, max_learning_rate: float, divide_factor: float = 25.0,
                 end_learning_rate: float = 0.0001, phase_pct: float = 0.3, anneal_strategy: str = "cos",
                 warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1, by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, max_learning_rate, warmup_epoch, warmup_start_lr, last_epoch,
                         by_epoch)
        self.total_steps = epochs if by_epoch else epochs * iters_per_epoch
        self.max_lr = max_learning_rate
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal_strategy = anneal_strategy

    def get_lr_fn(self) -> Schedule:
        up_steps = max(int(self.phase_pct * self.total_steps), 1)
        down_steps = max(self.total_steps - up_steps, 1)
        lr_i, lr_max, lr_end = self.initial_lr, self.max_lr, self.end_lr
        cos_mode = self.anneal_strategy == "cos"

        def sched(step: Step):
            t = self._t(step)
            tensor = isinstance(t, torch.Tensor)
            clip = (lambda v: torch.clamp(v, 0.0, 1.0)) if tensor else (lambda v: min(max(v, 0.0), 1.0))
            cos = torch.cos if tensor else math.cos

            def anneal(frac, a, b):
                if cos_mode:
                    return b + (a - b) * 0.5 * (1 + cos(math.pi * frac))
                return a + (b - a) * frac

            frac_up = clip(t / up_steps)
            up = anneal(1 - frac_up, lr_max, lr_i) if cos_mode else anneal(frac_up, lr_i, lr_max)
            down = anneal(clip((t - up_steps) / down_steps), lr_max, lr_end)
            if tensor:
                return torch.where(t < up_steps, up, down)
            return up if t < up_steps else down

        return sched


class LambdaDecay(LRBase):
    """lr0 * lr_lambda(t). On a tensor clock (a captured CUDA graph)
    ``lr_lambda`` receives the float32 clock tensor and must be tensor ops
    (no ``float()``, no Python branch on it), as the JAX package's must be
    traced jnp ops; on the eager path it receives an int."""

    def __init__(self, epochs: int, iters_per_epoch: int, learning_rate: float, lr_lambda: Callable,
                 warmup_epoch: int = 0, warmup_start_lr: float = 0.0, last_epoch: int = -1, by_epoch: bool = False):
        super().__init__(epochs, iters_per_epoch, learning_rate, warmup_epoch, warmup_start_lr, last_epoch, by_epoch)
        self.lr_lambda = lr_lambda

    def get_lr_fn(self) -> Schedule:
        lr0, fn = self.learning_rate, self.lr_lambda
        return lambda step: lr0 * fn(self._t(step))


class SchedulerList:
    """The schedules of an ``OptimizerList``, one per optimizer."""

    def __init__(self, scheduler_list: List[Schedule]):
        self.scheduler_list = list(scheduler_list)

    def __getitem__(self, i):
        return self.scheduler_list[i]

    def __len__(self):
        return len(self.scheduler_list)
