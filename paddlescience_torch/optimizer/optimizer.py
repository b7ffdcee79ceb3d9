"""Optimizers (counterpart of ``paddlescience_tpu/optimizer/optimizer.py``),
factory style: ``Adam(lr)(model)``.

Adam follows optax's update rule: bias-corrected moments and ``eps``
outside the square root, p <- p - lr(t) * m_hat / (sqrt(v_hat) + eps) with
lr evaluated at the step count before the update. ``torch.optim.Adam``
computes exactly that. On CUDA it runs with ``capturable=True`` and its
learning rate is a device tensor that :meth:`Optimizer.step` writes from
the schedule's tensor form, so a train step holds no host value and can be
captured in a CUDA graph; on the CPU the schedule's Python form sets the
learning rate each step.

Adam's state (moments and step counters) is made when the optimizer is
built, as torch would make it at the first step, so that the solver can
snapshot and checkpoint it from step 0 and a captured step never
allocates it.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ["Optimizer", "Adam"]

Schedule = Union[float, Callable]


class Optimizer:
    """A torch optimizer driven by a schedule ``lr_fn(step)``; ``lr_t`` is
    the device learning rate of a capturable optimizer (None on the CPU)."""

    def __init__(self, torch_opt: torch.optim.Optimizer, lr_fn: Callable, name: str,
                 lr_t: Optional[torch.Tensor] = None):
        self.torch_opt = torch_opt
        self.lr_fn = lr_fn
        self.name = name
        self.lr_t = lr_t

    def zero_grad(self) -> None:
        """Zero the gradients in place (their tensors stay where a captured
        step reads them)."""
        self.torch_opt.zero_grad(set_to_none=False)

    def step(self, step):
        """Apply one update at global step ``step`` and return the lr used:
        with ``lr_t`` set, ``step`` is the float32 device step counter and
        the lr a device tensor; otherwise an int and a float."""
        lr = self.lr_fn(step)
        if self.lr_t is not None:
            if isinstance(lr, torch.Tensor):
                self.lr_t.copy_(lr)
            else:
                self.lr_t.fill_(lr)
        else:
            lr = float(lr)
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
        cuda = bool(params) and params[0].is_cuda
        lr0 = float(self.lr_fn(0))
        lr_t = torch.tensor(lr0, device=params[0].device) if cuda else None
        opt = torch.optim.Adam(params, lr=lr_t if cuda else lr0, betas=(0.9, 0.999), eps=1e-8,
                               capturable=cuda, foreach=True if cuda else None)
        for p in params:
            opt.state[p].update(
                step=torch.zeros((), dtype=torch.float32, device=p.device if cuda else None),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
        return Optimizer(opt, self.lr_fn, "Adam", lr_t)
