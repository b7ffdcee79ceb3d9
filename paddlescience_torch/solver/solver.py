"""Solver — the training engine (counterpart of
``paddlescience_tpu/solver/solver.py``).

The JAX package jits one train step over all constraints. The port runs
the same step eagerly (no CUDA graph yet):

1. sample each device-sampled constraint's batch from the solver's
   ``torch.Generator`` (full-batch constraints were staged once);
2. every ``update_freq`` steps, refresh the loss aggregator's weights from
   per-loss gradient norms on a batch of their own, as the JAX solver's
   amortized refresh does before its step;
3. evaluate every constraint's expressions and loss
   (``_constraint_losses``);
4. aggregate with detached weights, back-propagate, and take the
   optimizer step at the schedule's learning rate.

Not ported yet: validators/eval, predict, checkpoints, learnable equation
parameters, EMA, microbatching and the autotuner.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss import mtl
from paddlescience_torch.utils import expression

__all__ = ["Solver"]


class Solver:
    """Trains ``model`` on ``constraint`` with ``optimizer``.

    ``device`` is where batches are drawn and the model runs (CUDA when
    None); ``seed`` seeds the solver's batch generator on that device.
    """

    def __init__(
        self,
        model,
        constraint: Dict[str, object],
        optimizer,
        epochs: int = 5,
        iters_per_epoch: int = 20,
        log_freq: int = 10,
        seed: int = 42,
        equation: Optional[Dict[str, object]] = None,
        loss_aggregator: Optional[mtl.LossAggregator] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.constraint = dict(constraint)
        self.optimizer = optimizer
        self.epochs = epochs
        self.iters_per_epoch = iters_per_epoch
        self.log_freq = log_freq
        self.equation = equation or {}
        for name, eq in self.equation.items():
            if getattr(eq, "learnable_parameters", None):
                raise NotImplementedError(f"equation '{name}': learnable parameters are not ported yet")
        self.loss_aggregator = loss_aggregator or mtl.Sum(model, len(self.constraint))
        self.agg_state = self.loss_aggregator.init_state(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.models = [model]
        self.step = 0
        self.loss_history: List[Tuple[int, float]] = []
        # per constraint: the derivative components its expressions request
        self._jet_requests: Dict[str, dict] = {name: {} for name in self.constraint}
        # full-batch constraints feed the same arrays every step: stage once
        self._static_batches = {
            name: tuple(self._to_device(part) for part in next(cst.data_iter))
            for name, cst in self.constraint.items()
            if cst.data_iter is not None
        }

    def _to_device(self, tree: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=self.device) for k, v in tree.items()}

    def _batches(self) -> Dict[str, tuple]:
        batches = dict(self._static_batches)
        for name, cst in self.constraint.items():
            if cst.data_iter is None:
                batches[name] = cst.dataset.sample_fn(self.generator)
        return batches

    def _constraint_losses(self, batches) -> Dict[str, torch.Tensor]:
        """One loss per constraint: the sum of its per-key losses."""
        losses = {}
        for name, cst in self.constraint.items():
            inp, lab, wgt = batches[name]
            outputs = expression.evaluate_expressions(self.models, inp, cst.output_expr,
                                                      request_cache=self._jet_requests[name])
            losses[name] = sum(cst.loss(outputs, lab, wgt if wgt else None).values())
        return losses

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _refresh_agg_weights(self) -> None:
        """Per-loss gradient norms over all parameters -> aggregator weights."""
        losses = self._constraint_losses(self._batches())
        params = self._params()
        norms = []
        for i, name in enumerate(losses):
            grads = torch.autograd.grad(losses[name], params, retain_graph=i < len(losses) - 1,
                                        allow_unused=True)
            norms.append(torch.sqrt(sum((g * g).sum() for g in grads if g is not None)))
        self.agg_state = self.loss_aggregator.update_weights(self.agg_state, torch.stack(norms))

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One optimizer step. Returns the step's logs as tensors on the
        device (reading them synchronises)."""
        agg = self.loss_aggregator
        if agg.needs_grad_norms and self.step % agg.update_freq == 0:
            self._refresh_agg_weights()
        losses = self._constraint_losses(self._batches())
        names = list(self.constraint)
        total, self.agg_state = agg.aggregate([losses[n] for n in names], self.agg_state)
        self.optimizer.zero_grad()
        total.backward()
        lr = self.optimizer.step(self.step)
        self.step += 1
        logs = {"loss": total.detach(), **{f"loss/{n}": losses[n].detach() for n in names}}
        logs["lr"] = torch.tensor(lr)
        return logs

    def train(self, num_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Run ``num_steps`` train steps (default: epochs * iters_per_epoch
        from the current step). Every ``log_freq`` steps and at the end the
        logs are read back and printed; returns those logged values."""
        if num_steps is None:
            num_steps = self.epochs * self.iters_per_epoch - self.step
        logged = []
        t0 = time.perf_counter()
        for i in range(num_steps):
            logs = self.train_step()
            if self.step % self.log_freq == 0 or i == num_steps - 1:
                vals = {k: float(v) for k, v in logs.items()}
                vals["step"] = self.step
                self.loss_history.append((self.step, vals["loss"]))
                logged.append(vals)
                parts = ", ".join(f"{k.split('/', 1)[1]}: {v:.5f}" for k, v in vals.items() if k.startswith("loss/"))
                print(f"[Train][Step {self.step}] lr: {vals['lr']:.2e}, loss: {vals['loss']:.5f} "
                      f"({parts}), {time.perf_counter() - t0:.1f}s", flush=True)
        return logged
