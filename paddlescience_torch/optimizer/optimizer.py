"""Optimizers (counterpart of ``paddlescience_tpu/optimizer/optimizer.py``),
factory style: ``Adam(lr)(model)``.

Adam follows optax's update rule: bias-corrected moments and ``eps``
outside the square root, p <- p - lr(t) * m_hat / (sqrt(v_hat) + eps) with
lr evaluated at the step count before the update. ``torch.optim.Adam``
computes exactly that; the schedule sets its learning rate each step.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

__all__ = ["Optimizer", "Adam"]

Schedule = Union[float, Callable[[int], float]]


class Optimizer:
    """A torch optimizer driven by a schedule ``lr_fn(step)``."""

    def __init__(self, torch_opt: torch.optim.Optimizer, lr_fn: Callable[[int], float], name: str):
        self.torch_opt = torch_opt
        self.lr_fn = lr_fn
        self.name = name

    def zero_grad(self) -> None:
        self.torch_opt.zero_grad(set_to_none=True)

    def step(self, step: int) -> float:
        """Apply one update at global step ``step``; returns the lr used."""
        lr = float(self.lr_fn(step))
        for group in self.torch_opt.param_groups:
            group["lr"] = lr
        self.torch_opt.step()
        return lr



class Adam:
    """Adam with the JAX package's defaults (beta1 0.9, beta2 0.999, eps
    1e-8; other values are not ported)."""

    def __init__(self, learning_rate: Schedule = 0.001):
        self.lr_fn = learning_rate if callable(learning_rate) else (lambda step, _lr=learning_rate: _lr)

    def __call__(self, *models) -> Optimizer:
        params = [p for m in models for p in m.parameters() if p.requires_grad]
        opt = torch.optim.Adam(params, lr=float(self.lr_fn(0)), betas=(0.9, 0.999), eps=1e-8)
        return Optimizer(opt, self.lr_fn, "Adam")
