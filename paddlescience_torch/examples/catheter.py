"""Catheter bacteria transport with an FNO1d, on the port (counterpart of
``examples/catheter.py``).

``FNO1d`` (``modes = width = 32``, 100 padding points) maps a catheter
channel's wall profile, (x, y) at S = 2001 points, to the log bacteria
density on the same points. The data are the JAX example's: the four .npy
arrays under ``data_dir`` when they are all there (every third column,
the three density columns averaged), otherwise its synthetic sawtooth
channels with an exponentially decaying contamination profile
(:func:`synth_data`, bitwise the same numpy draw). Loss: ``L2RelLoss``
summed over the batch; Adam (weight decay 1e-4) on a ``Step`` schedule
halving the rate every quarter of the run; shuffled batches of 16 (the
short last batch kept); the score ``L2Rel`` on 16 held-out synthetic
channels.

Run on the GPU: ``python -m paddlescience_torch.examples.catheter [epochs]``.
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.geofno import FNO1d
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import L2RelLoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.lr_scheduler import Step
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["S", "synth_data", "load_data", "build_solver"]

S = 2001  # sampled points per channel


def synth_data(n, seed=0):
    """``n`` synthetic channels: inputs (n, S, 2), log densities (n, S, 1)."""
    rng = np.random.default_rng(seed)
    xx = np.linspace(-500, 0, S, dtype="float32")
    inputs, labels = [], []
    for _ in range(n):
        amp = rng.uniform(5, 40)
        period = rng.uniform(30, 150)
        base = rng.uniform(10, 30)
        y = base + amp * np.abs(((xx / period) % 1.0) - 0.5) * 2  # sawtooth wall
        lam = 0.002 + 0.00005 * amp
        dist = np.clip(np.exp(lam * xx) * (1 + 0.3 * np.sin(2 * np.pi * xx / period)), 1e-6, None)
        inputs.append(np.stack([xx, y.astype("float32")], -1))
        labels.append(np.log(dist).astype("float32")[:, None])
    return np.stack(inputs), np.stack(labels)


def load_data(data_dir, n, seed=0):
    names = ("x_1d_structured_mesh.npy", "y_1d_structured_mesh.npy", "data_info.npy", "density_1d_data.npy")
    paths = [osp.join(data_dir or ".", f) for f in names]
    if data_dir and all(osp.exists(p) for p in paths):
        X, Y, para, out = (np.load(p) for p in paths)
        inputX, inputY = X[:, 0::3].T, Y[:, 0::3].T
        label = ((out[:, 0::3] + out[:, 1::3] + out[:, 2::3]) / 3.0).T
        inp = np.stack([inputX, inputY], -1).astype("float32")[:n].reshape(n, S, 2)
        return inp, np.log(np.clip(label[:n], 1e-6, None)).astype("float32")[..., None]
    print(f"[catheter] data under {data_dir!r} absent -> synthetic channels")
    return synth_data(n, seed)


def build_solver(epochs: int = 300, output_dir: Optional[str] = "./outputs_catheter", n_train: int = 64,
                 n_test: int = 16, batch_size: int = 16, learning_rate: float = 1e-3, modes: int = 32,
                 width: int = 32, data_dir: Optional[str] = "./dataset/catheter", *, shuffle: bool = True,
                 device: DeviceLike = None, seed: int = 42, log_freq: int = 20) -> Solver:
    device = resolve_device(device)
    np.random.seed(seed)
    random.seed(seed)
    x_train, y_train = load_data(data_dir, n_train, seed=0)
    x_test, y_test = load_data(None, n_test, seed=1)
    model = FNO1d(("input",), ("output",), modes=modes, width=width, padding=100, input_channel=2, output_np=S,
                  generator=torch.Generator().manual_seed(seed), device=device)
    iters = max(n_train // batch_size, 1)
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": {"input": x_train}, "label": {"output": y_train}},
         "batch_size": batch_size, "sampler": {"drop_last": False, "shuffle": shuffle}},
        L2RelLoss(reduction="sum"), name="sup_constraint")
    validator = {
        "catheter_valid": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": {"input": x_test}, "label": {"output": y_test}},
             "batch_size": n_test, "sampler": {"drop_last": False, "shuffle": False}},
            L2RelLoss(reduction="sum"), metric={"L2Rel": L2Rel()}, name="catheter_valid")
    }
    lr = Step(epochs, iters, learning_rate, step_size=max(epochs // 4, 1), gamma=0.5)()
    return Solver(model, {"sup_constraint": sup}, output_dir, Adam(lr, weight_decay=1e-4)(model), epochs=epochs,
                  iters_per_epoch=iters, eval_during_train=False, validator=validator, log_freq=log_freq, seed=seed,
                  device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 300)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final L2Rel = {solver.eval()[0]:.4e}")
