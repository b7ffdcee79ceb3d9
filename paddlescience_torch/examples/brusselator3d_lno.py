"""Laplace neural operator for the (2+1)-D Brusselator on the port
(counterpart of ``examples/brusselator3d_lno.py``).

The data set (inputs: 1-D forcing signals on 39 time frames; outputs: the
responses u(t, x, y) on 28 x 28) comes from the port's generator
(``data/dataset/brusselator.py``, 800 + 200 samples rolled out on the
device) or from an ``.npz`` of the same layout (``data_path``). As in the
JAX example (``DataFuncs``): subsampled by r = 2 and cropped to s = 14
points a side, the input signal tiled over space, t/x/y grids appended as
channels, fields min-max encoded. LNO with width 8, modes (4, 4, 4),
hidden 64, relu and the instance norm; AdamW at 5e-3 with weight decay
1e-4 on a ``Step`` schedule halving the rate every 100 epochs; the L2Rel
loss summed over the batch; shuffled batches of 50 (``drop_last=False``),
16 steps an epoch, 300 epochs; the validator reports the L2Rel of the
decoded prediction on the test set.

Run on the GPU: ``python -m paddlescience_torch.examples.brusselator3d_lno
[epochs] [data.npz]`` (each epoch one CUDA graph of 16 steps).
"""

from __future__ import annotations

import random
import sys
from typing import Dict, Optional

import numpy as np
import torch

from paddlescience_torch.arch.lno import LNO
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.data.dataset import brusselator
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import L2RelLoss
from paddlescience_torch.metric import FunctionalMetric
from paddlescience_torch.optimizer.lr_scheduler import Step
from paddlescience_torch.optimizer.optimizer import AdamW
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["DataFuncs", "build_solver"]

NUM_T, NUM_XY = brusselator.NT, brusselator.NX
ORIG_R, RESOLUTION = 28, 2


class DataFuncs:
    """Subsample, crop, tile the 1-D input over space, append t/x/y grid
    channels, min-max encode (the JAX example's ``DataFuncs``)."""

    def __init__(self, orig_r=ORIG_R, r=RESOLUTION, nt=NUM_T):
        self.orig_r, self.r, self.nt = orig_r, r, nt
        self.s = int((orig_r - 1) / r + 1)
        x = np.linspace(0, 1, orig_r)
        t = np.linspace(0, 1, nt)
        self.tt, self.xx, self.yy = np.meshgrid(t, x, x, indexing="ij")

    def gen_grid(self, grid, num):
        g = np.tile(grid, (num, 1, 1, 1))[:, :, :: self.r, :: self.r][:, :, : self.s, : self.s]
        return g.reshape(num, self.nt, self.s, self.s, 1)

    def cat_grid(self, data):
        n = data.shape[0]
        return np.concatenate([data, self.gen_grid(self.tt, n), self.gen_grid(self.xx, n), self.gen_grid(self.yy, n)],
                              axis=-1).astype(data.dtype)

    def transform(self, data, key="input"):
        if key == "input":  # (N, nt) signal -> tiled (N, nt, R, R)
            data = np.transpose(np.tile(data[None], (self.orig_r, self.orig_r, 1, 1)), (2, 3, 0, 1))
        data = data[:, :, :: self.r, :: self.r][:, :, : self.s, : self.s]
        return data.reshape(data.shape[0], self.nt, self.s, self.s, 1)

    @staticmethod
    def get_mean_std(data):
        lo, hi = np.min(data), np.max(data)
        return (lo + hi) / 2, (hi - lo) / 2

    @staticmethod
    def encode(data, mean, std):
        return (data - mean) / std


def build_solver(epochs: int = 300, iters_per_epoch: int = 16, batch_size: int = 50,
                 output_dir: Optional[str] = "./output_brusselator3d", n_train: Optional[int] = None, *,
                 data: Optional[Dict[str, np.ndarray]] = None, data_path: Optional[str] = None, shuffle: bool = True,
                 device: DeviceLike = None, seed: int = 42, log_freq: int = 100) -> Solver:
    """The Brusselator LNO solver of the JAX example, on ``data`` (the
    generator's four arrays), else the ``.npz`` at ``data_path``, else data
    generated on ``device``. The model's weights come from a
    ``torch.Generator`` seeded with ``seed``, the loader's shuffled order
    from another (``shuffle=False`` walks the samples in order, as the JAX
    loader does then)."""
    device = resolve_device(device)
    if data is None:
        data = brusselator.load_or_generate(data_path, device=device)
    np.random.seed(seed)
    random.seed(seed)
    funcs = DataFuncs()
    in_tr = funcs.transform(data["inputs_train"], "input")
    lab_tr = funcs.transform(data["outputs_train"], "label")
    in_te = funcs.transform(data["inputs_test"], "input")
    lab_te = funcs.transform(data["outputs_test"], "label")
    if n_train:
        in_tr, lab_tr = in_tr[:n_train], lab_tr[:n_train]
    in_mean, in_std = funcs.get_mean_std(in_tr)
    lab_mean, lab_std = funcs.get_mean_std(lab_tr)
    in_tr_enc = funcs.cat_grid(funcs.encode(in_tr, in_mean, in_std))
    in_te_enc = funcs.cat_grid(funcs.encode(in_te, in_mean, in_std))
    lab_tr_enc = funcs.encode(lab_tr, lab_mean, lab_std)

    T = np.linspace(0, 19, NUM_T, dtype=np.float32).reshape(1, NUM_T)
    X = np.linspace(0, 1, ORIG_R, dtype=np.float32).reshape(1, ORIG_R)[:, : funcs.s]
    model = LNO(("input",), ("output",), width=8, modes=(4, 4, 4), T=T, data=(X, X), in_features=4,
                hidden_features=64, activation="relu", use_norm=True, generator=torch.Generator().manual_seed(seed),
                device=device)
    lr = Step(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=5e-3, step_size=100, gamma=0.5,
              by_epoch=True)()
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": {"input": in_tr_enc}, "label": {"output": lab_tr_enc}},
         "batch_size": batch_size, "sampler": {"name": "BatchSampler", "shuffle": shuffle, "drop_last": False}},
        L2RelLoss("sum"), name="sup")

    def decoded_l2rel(out_dict, label_dict):
        """The mean per-sample L2Rel of the prediction decoded to physical units."""
        pred = out_dict["output"] * float(lab_std) + float(lab_mean)
        ref = label_dict["output"]
        num = torch.linalg.vector_norm((pred - ref).reshape(pred.shape[0], -1), dim=1)
        den = torch.linalg.vector_norm(ref.reshape(ref.shape[0], -1), dim=1)
        return {"L2Rel": torch.mean(num / den)}

    validator = {
        "sup_valid": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": {"input": in_te_enc}, "label": {"output": lab_te}},
             "batch_size": batch_size},
            L2RelLoss("sum"), {"output": lambda out: out["output"]},
            metric={"decoded": FunctionalMetric(decoded_l2rel)}, name="sup_valid")
    }
    return Solver(model, {"sup": sup}, output_dir, AdamW(lr, weight_decay=1e-4)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, validator=validator, eval_during_train=False, log_freq=log_freq,
                  seed=seed, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 300, data_path=argv[1] if len(argv) > 1 else None)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final decoded L2Rel = {solver.eval()[0]:.4e}")
