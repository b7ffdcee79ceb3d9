"""K training steps in one CUDA graph: the ``Solver``'s chunks and the
hand-written loops.

A step is a Python function that updates the parameters and the optimizer
state in place and returns its logs as device tensors. :class:`StepGraph`
runs K of them eagerly on the CPU; on CUDA it captures the K steps once in
a CUDA graph, as the JAX code jits one step (or scans K): a few eager
warm-up steps on a side stream (building the kernels and the expression
evaluators' derivative requests), the state restored in place, then the
capture. Every later call with the same K replays the graph. Anything a
step reads that changes between calls (hPINNs' multipliers and penalty, a
solver's staged batches) must live in device tensors that the caller
updates in place: a graph is never recaptured.

A graph is kept for what chose its kernels (:func:`graph_key`): K, the
process's derivative path (``autodiff/path.py``) and whether cuDNN is held
to its deterministic algorithms. A step run under another path or setting
captures a graph of its own instead of replaying one that runs the old
kernels.

Python's cyclic garbage collector is paused during a capture: a graph it
freed then (one that a dropped object kept in a reference cycle) would be
destroyed while the stream captures, which CUDA refuses, and the capture
would fail. Owners hand the loop callables that reach them through a weak
reference (``weakref.proxy``), so a dropped solver or model frees its
graphs and their memory pools at once.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from paddlescience_torch.autodiff import path as deriv_path

__all__ = ["StepGraph", "graph_key", "deterministic_convs", "WARMUP_STEPS"]

WARMUP_STEPS = 3  # eager steps on a side stream before a capture (then undone)

Logs = Dict[str, torch.Tensor]


def graph_key(k: int, path: Optional[Dict[str, object]] = None) -> tuple:
    """The key of a K-step graph captured under ``path`` (default: the
    process's derivative path) and cuDNN's current determinism."""
    path = deriv_path.get_default() if path is None else path
    return (k, tuple(sorted(path.items())), bool(torch.backends.cudnn.deterministic))


@contextlib.contextmanager
def deterministic_convs() -> Iterator[None]:
    """cuDNN held to its deterministic algorithms inside the block. Some of
    its weight-gradient algorithms sum with atomics, in an order that
    changes from call to call, so a graphed step and the same step run
    eagerly agree bitwise only under this; a graph captured inside is kept
    apart from one captured outside (:func:`graph_key`)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class StepGraph:
    """``step(i)`` runs the chunk's i-th training step in place and returns
    its logs. The state a step changes is given either as ``state()``, the
    list of those tensors, or as ``snapshot()`` and ``restore(snap)``; the
    warm-up before a capture is undone with it. ``generator``, where the
    steps draw from one, is registered with each graph. ``stats[k]`` holds
    the warm-up's and the capture's seconds of the last K-step capture and
    the replays since."""

    def __init__(self, step: Callable[[int], Logs], device: torch.device, *,
                 state: Optional[Callable[[], Sequence[torch.Tensor]]] = None,
                 snapshot: Optional[Callable[[], object]] = None, restore: Optional[Callable[[object], None]] = None,
                 generator: Optional[torch.Generator] = None):
        if (state is None) == (snapshot is None or restore is None):
            raise ValueError("give state, or snapshot and restore")
        self.step = step
        self.device = torch.device(device)
        self.state = state
        self._snapshot, self._restore = snapshot, restore
        self.generator = generator
        self.graphs: Dict[tuple, Tuple[torch.cuda.CUDAGraph, Logs]] = {}
        self.stats: Dict[int, Dict[str, float]] = {}

    def snapshot(self):
        if self._snapshot is not None:
            return self._snapshot()
        return [t.detach().clone() for t in self.state()]

    @torch.no_grad()
    def restore(self, snap) -> None:
        if self._restore is not None:
            self._restore(snap)
            return
        for dst, src in zip(self.state(), snap):
            dst.copy_(src)

    def graph(self, k: int) -> Tuple[torch.cuda.CUDAGraph, Logs]:
        """The CUDA graph of ``k`` steps under :func:`graph_key`, captured at
        first use, and its last step's logs. Raises ``RuntimeError`` if the
        capture fails (a kernel's shape refusal as it is); there is no eager
        fallback."""
        key = graph_key(k)
        if key in self.graphs:
            return self.graphs[key]
        if self.generator is not None and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("this torch cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state); run one step at a time")
        snap = self.snapshot()
        t0 = time.perf_counter()
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for i in range(WARMUP_STEPS):
                    self.step(i % k)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.restore(snap)
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    for i in range(k):
                        logs = self.step(i)
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(self.device)
        except Exception as e:
            from paddlescience_torch.ops.jet_mlp import KernelRefusal

            self.restore(snap)
            if isinstance(e, KernelRefusal):  # a shape refusal before any launch, not a capture failure
                raise
            raise RuntimeError(f"capturing {k} steps in one CUDA graph failed: {e}") from e
        self.stats[k] = {"warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1, "replays": 0}
        self.graphs[key] = (graph, logs)
        return graph, logs

    def run(self, k: int, graphed: bool = True) -> Logs:
        """``k`` steps from the current state: one replay of the captured
        graph on CUDA (``graphed``), else ``k`` eager steps. Returns the
        last step's logs as device tensors."""
        if graphed and self.device.type == "cuda":
            graph, logs = self.graph(k)
            graph.replay()
            self.stats[k]["replays"] += 1
            return logs
        for i in range(k):
            logs = self.step(i)
        return logs

    def release(self) -> None:
        """Drop the captured graphs (their memory pools go with them)."""
        self.graphs.clear()
