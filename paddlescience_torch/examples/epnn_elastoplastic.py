"""EPNN, the elasto-plastic constitutive network, on the port (counterpart
of ``examples/epnn_elastoplastic.py``).

Learns the stress increment of a 1-D elastic-perfectly-plastic law (E = 2,
yield 0.5) from (strain, stress, strain increment) states: 256 random
states, each returned to the yield surface (:func:`synthetic_paths`, a
numpy copy bitwise equal to the JAX example's). Epnn 3 -> 64 -> 64 -> 1
(leaky ReLU, the last layer without bias); MSE over shuffled batches of 64
(4 steps an epoch, the short batch dropped); Adam at 2e-3; the validator's
MAE over all 256 states.

Run on the GPU: ``python -m paddlescience_torch.examples.epnn_elastoplastic
[epochs]`` (each epoch one CUDA graph of 4 steps).
"""

from __future__ import annotations

import random
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.misc_nets import Epnn
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MAE
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "synthetic_paths"]

SEED = 0  # the JAX example's set_random_seed


def synthetic_paths(n: int = 256, seed: int = 0) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Random strain increments -> (stress, elastic strain) by return mapping."""
    rng = np.random.default_rng(seed)
    E, YIELD = 2.0, 0.5
    eps = rng.uniform(-0.4, 0.4, n)
    deps = rng.uniform(-0.1, 0.1, n)
    sig = np.clip(E * eps, -YIELD, YIELD)  # the current stress, on or inside the yield surface
    sig_new = np.clip(sig + E * deps, -YIELD, YIELD)
    x = np.stack([eps, sig, deps], 1).astype(np.float32)
    y = (sig_new - sig).astype(np.float32)[:, None]
    return {"state": x}, {"dstress": y}


def build_solver(epochs: int = 6, output_dir: Optional[str] = "./output_epnn", *, device: DeviceLike = None) -> Solver:
    """The EPNN solver of the JAX example. The weights come from a
    ``torch.Generator`` seeded with ``SEED``, the loader's shuffled order
    from another."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    model = Epnn(("state",), ("dstress",), node_sizes=(3, 64, 64, 1), activations=("leaky_relu", "leaky_relu"),
                 generator=torch.Generator().manual_seed(SEED), device=device)
    inp, lab = synthetic_paths()
    dl = {"dataset": {"name": "NamedArrayDataset", "input": inp, "label": lab}, "batch_size": 64,
          "sampler": {"name": "BatchSampler", "shuffle": True, "drop_last": True}}
    sup = SupervisedConstraint(dl, MSELoss("mean"), {"dstress": lambda out: out["dstress"]}, name="Sup")
    validator = SupervisedValidator(
        {**dl, "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}}, MSELoss("mean"),
        {"dstress": lambda out: out["dstress"]}, metric={"MAE": MAE()}, name="epnn_valid")
    return Solver(model, {"Sup": sup}, output_dir, Adam(2e-3)(model), epochs=epochs, iters_per_epoch=4,
                  validator={"epnn_valid": validator}, eval_during_train=False, log_freq=8, seed=SEED,
                  device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 6)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final MAE.dstress = {solver.eval()[0]:.4e}")
