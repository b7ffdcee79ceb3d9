"""FourCastNet's finetune stage, on the port (counterpart of
``examples/fourcastnet_finetune.py``): the AFNONet rolled out two steps,
each supervised by its frame (t + 1, t + 2), warm-started from the
pretrain stage's checkpoint (``fourcastnet.py``; its parameters do not
depend on the rollout length).

Run on the GPU: ``python -m paddlescience_torch.examples.fourcastnet_finetune
[pretrained checkpoint [epochs]]``.
"""

from __future__ import annotations

import sys
from typing import Optional

from paddlescience_torch.examples.fourcastnet import build_solver as _build_solver
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver"]


def build_solver(pretrained_model_path: Optional[str] = None, num_timestamps: int = 2, **kwargs) -> Solver:
    kwargs.setdefault("output_dir", "./output_fourcastnet_finetune")
    return _build_solver(num_timestamps=num_timestamps, pretrained_model_path=pretrained_model_path, **kwargs)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(argv[0] if argv else None, epochs=int(argv[1]) if len(argv) > 1 else 4)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final RMSE = {solver.eval()[0]:.4e}")
