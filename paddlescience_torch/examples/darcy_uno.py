"""Darcy flow operator learning with a UNO, on the port (counterpart of
``examples/darcy_uno.py``): ``darcy_tfno.build_solver`` with
``arch="uno"``, which holds everything else.

Run on the GPU: ``python -m paddlescience_torch.examples.darcy_uno
[epochs]`` (each epoch one CUDA graph of ``n_train // 16`` steps).
"""

from __future__ import annotations

import sys

from paddlescience_torch.examples.darcy_tfno import build_solver as _build_solver
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver"]


def build_solver(*args, **kwargs) -> Solver:
    """``darcy_tfno.build_solver(..., arch="uno")``; its output directory
    defaults to ``./output_darcy_uno``."""
    kwargs.setdefault("output_dir", "./output_darcy_uno")
    return _build_solver(*args, arch="uno", **kwargs)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 300)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final l2 = {solver.eval()[0]:.4e}")
