"""The hand loop of the graph examples (AMGNet, CFDGCN, GraphCast, CGCNN):
Adam on the mean squared error of one sample a step, the samples in turn,
as the JAX examples' jitted ``step`` loops.

Each sample is an input dict (feature tensors on the device, graph indices
on the host) and a label tensor. On CUDA each sample's step is captured
once in a CUDA graph of its own (``utils/step_graph.py``, one
``StepGraph`` a sample: each graph has its own sizes and segment tables)
and replayed whenever that sample's turn comes; the message sums and
gathers are fixed-order (``nn/segment.py``), so a replayed step equals the
eager one bitwise.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.utils.step_graph import StepGraph

__all__ = ["GraphFit", "to_device"]


class GraphFit:
    """``model``, Adam at ``lr`` (optax's rule) and ``samples``, a list of
    (input dict, label) on ``device``; the prediction is
    ``model(inputs)[out_key]``."""

    def __init__(self, model, samples: Sequence[Tuple[Dict, torch.Tensor]], lr: float, out_key: str,
                 device: torch.device):
        self.model = model
        self.samples = list(samples)
        self.out_key = out_key
        self.device = torch.device(device)
        self.opt = Adam(lr)(model)
        self.step = 0
        me = weakref.proxy(self)  # the loops reach the fit weakly: dropping it frees its graphs
        self.loops = [StepGraph(lambda i, j=j: me._step(j), self.device, state=lambda: me.state())
                      for j in range(len(self.samples))]

    def loss(self, j: int) -> torch.Tensor:
        inp, y = self.samples[j]
        return torch.mean((self.model(inp)[self.out_key] - y) ** 2)

    def state(self) -> List[torch.Tensor]:
        """The tensors a step changes: parameters and Adam's moments and step."""
        out = list(self.model.parameters())
        out += [t for s in self.opt.state_tensors().values() for t in s.values() if isinstance(t, torch.Tensor)]
        return out

    def snapshot(self) -> List[torch.Tensor]:
        return [t.detach().clone() for t in self.state()]

    @torch.no_grad()
    def restore(self, snap: List[torch.Tensor], step: int) -> None:
        for dst, src in zip(self.state(), snap):
            dst.copy_(src)
        self.step = step

    def _step(self, j: int) -> Dict[str, torch.Tensor]:
        self.opt.zero_grad()
        loss = self.loss(j)
        loss.backward()
        self.opt.step(0)
        return {"loss": loss.detach()}

    def train_steps(self, steps: int, graphed: bool = True) -> List[torch.Tensor]:
        """``steps`` steps from the current one, sample ``step % n`` each
        (a replay of that sample's graph on CUDA when ``graphed``); returns
        each step's loss, copied on the device (no host sync)."""
        losses = []
        for _ in range(steps):
            logs = self.loops[self.step % len(self.samples)].run(1, graphed=graphed)
            losses.append(logs["loss"].clone())
            self.step += 1
        return losses

    def fit(self, steps: int, graphed: bool = True) -> Tuple[float, float]:
        """The JAX example's loop: ``steps`` steps; returns the first and
        last step's loss and raises if the loss did not fall."""
        losses = self.train_steps(steps, graphed)
        first, last = float(losses[0]), float(losses[-1])
        if not last < first:
            raise AssertionError(f"the loss did not fall: {first} -> {last} over {steps} steps")
        return first, last

    def release(self) -> None:
        for loop in self.loops:
            loop.release()


def to_device(arrays: Sequence, device: torch.device, host: Optional[Sequence[int]] = ()) -> tuple:
    """A graph tuple with its float arrays as tensors on ``device`` and the
    positions in ``host`` (index arrays) kept on the host."""
    return tuple(a if i in host else torch.as_tensor(a, dtype=torch.float32, device=device)
                 for i, a in enumerate(arrays))
