"""The common part of the hand-written training loops of phylstm_seismic,
phycrnet_burgers, tempogan_lite, velocitygan_fwi, yinglong and
physformer_lorenz's stage 1: the state a step changes (the parameters of ``modules`` and the state of ``optimizers``),
the step loop (``utils/step_graph.py``: on CUDA K steps to a CUDA graph),
the GAN examples' step pair, and a run of the JAX examples' ``main`` that
reports and checks the loss's fall.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Tuple

import torch

from paddlescience_torch.utils.step_graph import StepGraph

__all__ = ["GANLoop", "HandLoop", "run_and_check"]


class HandLoop:
    """Subclasses set ``modules`` and ``optimizers`` and define ``loss()``
    (one optimizer) or override ``_step()``, then call
    :meth:`_start_loop`."""

    modules: List[torch.nn.Module]
    optimizers: list

    def _start_loop(self, device) -> None:
        me = weakref.proxy(self)  # the loop reaches its owner weakly: dropping the owner frees its graphs
        self.loop = StepGraph(lambda i: me._step(), device, state=lambda: me.state())

    def state(self) -> List[torch.Tensor]:
        out = [p for m in self.modules for p in m.parameters()]
        for opt in self.optimizers:
            out += [t for s in opt.state_tensors().values() for t in s.values()]
        return out

    def _step(self) -> Dict[str, torch.Tensor]:
        (opt,) = self.optimizers
        opt.zero_grad()
        loss = self.loss()
        loss.backward()
        opt.step(0)
        return {"loss": loss.detach()}

    def train_steps(self, n: int, k: int = 1) -> Dict[str, float]:
        """``n`` steps in chunks of ``k`` (one graph replay each on CUDA
        when k > 1); returns the last step's logs."""
        if n % k:
            raise ValueError(f"{n} steps do not split into chunks of {k}")
        for _ in range(n // k):
            logs = self.loop.run(k, graphed=k > 1)
        return {name: float(v) for name, v in logs.items()}


class GANLoop(HandLoop):
    """A generator ``gen`` and a discriminator ``disc``, each with its own
    optimizer (``g_opt``, ``d_opt``). A step is the JAX examples' pair: the
    discriminator's step on ``d_loss()``, then the generator's, against the
    updated discriminator, on the loss that ``g_loss()`` returns beside the
    logs it adds."""

    def g_loss(self) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def _start_loop(self, device) -> None:
        self.modules, self.optimizers = [self.gen, self.disc], [self.g_opt, self.d_opt]
        super()._start_loop(device)

    def _step(self) -> Dict[str, torch.Tensor]:
        self.d_opt.zero_grad()
        d_loss = self.d_loss()
        d_loss.backward()
        self.d_opt.step(0)
        self.g_opt.zero_grad()
        g_loss, logs = self.g_loss()
        g_loss.backward(inputs=list(self.gen.parameters()))  # the discriminator stays as it is
        self.g_opt.step(0)
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), **{k: v.detach() for k, v in logs.items()}}


def run_and_check(fit: HandLoop, steps: int, label: str, fmt: str = ".6f", key: str = "loss") -> float:
    """``steps`` steps of ``fit``; prints the first and last value of the
    log ``key`` and raises if it did not fall."""
    first = last = fit.train_steps(1)[key]
    if steps > 1:
        last = fit.train_steps(steps - 1)[key]
    print(f"{label}: {first:{fmt}} -> {last:{fmt}} over {steps} steps")
    if not last < first:
        raise AssertionError(f"the {key} did not fall: {first} -> {last}")
    return last
