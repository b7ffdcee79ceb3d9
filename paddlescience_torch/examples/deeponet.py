"""DeepONet antiderivative operator on the port (counterpart of
``examples/deeponet.py``): G(u)(y) = int_0^y u(s) ds.

The data are generated, as in the JAX example: u is a sum of eight
random-amplitude cosines sampled at 100 sensors, y a uniform query point
and G the exact antiderivative there (:func:`make_data`, a numpy copy
bitwise equal to the JAX function). DeepONet(100 sensors, 40 features, one
hidden layer of 40 in branch and trunk, relu); a ``SupervisedConstraint``
over an indexed ``NamedArrayDataset`` of ``n_train`` samples, batches of
312 drawn in a shuffled order by a ``BatchLoader`` (a new batch each
step, copied to the device from pinned memory); MSE; Adam at 1e-3. The
``G_validator`` holds G against ``n_eval`` fresh samples (L2Rel, batches
of 500).

Run on the GPU: ``python -m paddlescience_torch.examples.deeponet [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.deeponet import DeepONet
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "make_data"]


def make_data(n_samples: int, m: int = 100, seed: int = 0) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``n_samples`` functions u (m sensors on [0, 1]), query points y and
    the antiderivatives G(u)(y), from ``np.random.default_rng(seed)``:
    u(x) = sum_k a_k cos(k pi x + phi_k), a_k ~ N(0, 1) / (1 + k), phi_k ~
    U(0, 2 pi), k = 0..7."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 1, m, dtype=np.float32)
    k = np.arange(8)[None, :]
    amp = rng.normal(size=(n_samples, 8)).astype(np.float32) / (1 + k)
    phase = rng.uniform(0, 2 * np.pi, size=(n_samples, 8)).astype(np.float32)
    u = np.einsum("sk,skm->sm", amp, np.cos(np.pi * k[..., None] * xs[None, None, :] + phase[..., None])).astype(
        np.float32)
    y = rng.uniform(0, 1, size=(n_samples, 1)).astype(np.float32)
    # the exact antiderivative: sum_k a_k [sin(k pi y + phi_k) - sin(phi_k)] / (k pi); k = 0: a_0 cos(phi_0) y
    G = np.zeros((n_samples, 1), np.float32)
    for kk in range(8):
        if kk == 0:
            G[:, 0] += amp[:, 0] * np.cos(phase[:, 0]) * y[:, 0]
        else:
            G[:, 0] += amp[:, kk] * (np.sin(kk * np.pi * y[:, 0] + phase[:, kk]) - np.sin(phase[:, kk])) / (kk * np.pi)
    return {"u": u, "y": y}, {"G": G}


def build_solver(epochs: int = 100, iters_per_epoch: int = 32, output_dir: Optional[str] = "./output_deeponet",
                 n_train: int = 10000, batch_size: int = 312, n_eval: int = 2000, seed: int = 42, *,
                 shuffle: bool = True, device: DeviceLike = None, log_freq: int = 200) -> Solver:
    """The DeepONet solver of the JAX example. The model's weights come from
    a ``torch.Generator`` seeded with ``seed``, the loader's shuffled order
    from another (the JAX loader draws it with numpy, so the orders
    differ; ``shuffle=False`` walks the samples in order in both)."""
    device = resolve_device(device)
    np.random.seed(seed)
    random.seed(seed)
    model = DeepONet("u", "y", "G", 100, 40, 1, 1, 40, 40, branch_activation="relu", trunk_activation="relu",
                     generator=torch.Generator().manual_seed(seed), device=device)
    train_in, train_lab = make_data(n_train, seed=seed)
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": train_in, "label": train_lab},
         "batch_size": min(batch_size, n_train), "sampler": {"shuffle": shuffle}},
        MSELoss(), {"G": lambda out: out["G"]}, name="Sup")
    eval_in, eval_lab = make_data(n_eval, seed=7)
    validator = {
        "G_validator": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": eval_in, "label": eval_lab}, "batch_size": 500},
            MSELoss(), {"G": lambda out: out["G"]}, metric={"L2Rel": L2Rel()}, name="G_validator")
    }
    return Solver(model, {"Sup": sup}, output_dir, Adam(1e-3)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  validator=validator, log_freq=log_freq, seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 100)
    solver.train()
    print(f"final L2Rel.G = {solver.eval()[0]:.4e}")
