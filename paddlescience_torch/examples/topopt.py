"""TopOpt: neural topology optimisation, on the port (counterpart of
``examples/topopt.py``; reference ``examples/topopt/topopt.py``, Sosnovik
& Oseledets 2019, arXiv:1709.09578).

``UNetEx`` (filters 16/32/64, 2 convolutions a block, sigmoid output) maps
an intermediate SIMP density snapshot (2 channels: X_k and X_k - X_{k-5})
to the final binary topology. The data are the JAX example's synthetic
SIMP-like sequences (:func:`synthesize_simp`, the same numpy draws; an
HDF5 archive with ``iters`` (N, T, H, W) and ``targets`` (N, H, W) when
``data_path`` is given), the channel sampler k ~ Uniform | Poisson | Fixed
(:func:`make_sampler`), a random D4 transformation of every training batch
(:func:`augmentation`, a dataset transform drawing from numpy's global
generator, as the JAX one). Loss: binary cross-entropy plus ``vol_coeff``
x (mean density mismatch)^2 (``FunctionalLoss``); metrics Binary_Acc and
IoU (``FunctionalMetric``). Adam (eps 1e-7) at lr / (1 + epochs // 15),
batches of 16 (shuffled, the short last kept: train() takes one eager
step at a time, as the JAX solver retraces for it).

Run on the GPU: ``python -m paddlescience_torch.examples.topopt [epochs]``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.unetex import UNetEx
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss
from paddlescience_torch.metric import FunctionalMetric
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["synthesize_simp", "make_sampler", "channel_sample", "augmentation", "conf_loss_fn", "val_metric",
           "build_solver"]


def synthesize_simp(n_samples=64, H=40, W=40, n_iters=24, seed=0):
    """SIMP-like sequences: a smooth random field, progressively binarised."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    iters = np.zeros((n_samples, n_iters, H, W), np.float32)
    targets = np.zeros((n_samples, H, W), np.float32)
    for i in range(n_samples):
        field = np.zeros((H, W), np.float32)
        for _ in range(rng.integers(3, 7)):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            sig = rng.uniform(H / 8, H / 3)
            field += rng.uniform(0.5, 1.5) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
        thresh = np.quantile(field, 1.0 - rng.uniform(0.3, 0.5))  # the volume fraction
        targets[i] = (field > thresh).astype(np.float32)
        for k in range(n_iters):
            sharp = 0.5 + 8.0 * (k / (n_iters - 1)) ** 2
            x = 1.0 / (1.0 + np.exp(-sharp * (field - thresh) * 8.0))
            x += 0.05 * (1 - k / n_iters) * rng.standard_normal((H, W))
            iters[i, k] = np.clip(x, 0.0, 1.0)
    return iters, targets


def make_sampler(kind: str, num: int, n_iters: int):
    rng = np.random.default_rng(1)
    hi = n_iters - 1
    if kind == "Fixed":
        return lambda: min(max(num, 1), hi)
    if kind == "Poisson":
        return lambda: min(max(int(rng.poisson(num)), 1), hi)
    return lambda: int(rng.integers(1, hi + 1))  # Uniform


def channel_sample(iters, sampler):
    """(N, T, H, W) -> (N, 2, H, W): the snapshot at k and its 5-step increment."""
    n = len(iters)
    x = np.zeros((n, 2, *iters.shape[2:]), np.float32)
    for i in range(n):
        k = sampler()
        x[i, 0] = iters[i, k]
        x[i, 1] = iters[i, k] - iters[i, max(k - 5, 0)]
    return x


def augmentation(inp, lab, wgt):
    """A random D4 transformation of a batch (reference functions.py:102-134)."""
    x, y = inp["input"], lab["output"]
    if np.random.random() > 0.5:
        x, y = np.flip(x, -1), np.flip(y, -1)
    if np.random.random() > 0.5:
        x, y = np.flip(x, -2), np.flip(y, -2)
    if np.random.random() > 0.5:
        x, y = np.rot90(x, axes=(-2, -1)), np.rot90(y, axes=(-2, -1))
    return {"input": np.ascontiguousarray(x)}, {"output": np.ascontiguousarray(y)}, wgt


def conf_loss_fn(vol_coeff: float):
    """Binary cross-entropy (the prediction clipped to [1e-7, 1 - 1e-7])
    plus ``vol_coeff`` x the squared mean mismatch."""
    def conf_loss(out, lab, wgt=None):
        p = torch.clamp(out["output"], 1e-7, 1 - 1e-7)
        t = lab["output"]
        bce = -torch.mean(t * torch.log(p) + (1 - t) * torch.log(1 - p))
        vol = torch.square(torch.mean(t - p))
        return {"output": bce + vol_coeff * vol}
    return conf_loss


def val_metric(out, lab):
    """Binary accuracy and the mean IoU of the two classes, on rounded maps."""
    pred = torch.round(out["output"])
    true = torch.round(lab["output"])
    acc = torch.mean((pred == true).float())
    tp = torch.sum((pred == 1) & (true == 1))
    tn = torch.sum((pred == 0) & (true == 0))
    fp = torch.sum((pred == 0) & (true == 1))
    fn = torch.sum((pred == 1) & (true == 0))
    iou = 0.5 * (tn / (tn + fn + fp + 1e-9) + tp / (tp + fp + fn + 1e-9))
    return {"Binary_Acc": acc, "IoU": iou}


def build_solver(epochs: int = 8, batch_size: int = 16, n_samples: int = 64, vol_coeff: float = 1.0,
                 learning_rate: float = 1e-3, sampler=("Uniform", 0), data_path: Optional[str] = None,
                 output_dir: Optional[str] = "./output_topopt", seed: int = 42, *,
                 device: DeviceLike = None) -> Solver:
    """The JAX example's solver."""
    device = resolve_device(device)
    np.random.seed(seed)
    if data_path:
        from paddlescience_torch.data.dataset.domain_dataset import import_h5py

        with import_h5py().File(data_path, "r") as f:
            iters = np.asarray(f["iters"], np.float32)[:n_samples]
            targets = np.asarray(f["targets"], np.float32)[:n_samples]
    else:
        iters, targets = synthesize_simp(n_samples=n_samples, seed=seed)
    x = channel_sample(iters, make_sampler(sampler[0], sampler[1], iters.shape[1]))
    y = targets[:, None]  # (N, 1, H, W)
    n_train = int(0.8 * len(x))
    model = UNetEx("input", "output", in_channel=2, out_channel=1, kernel_size=3, filters=(16, 32, 64), layers=2,
                   weight_norm=False, batch_norm=False, final_activation="sigmoid",
                   generator=torch.Generator().manual_seed(seed), device=device)
    loss = FunctionalLoss(conf_loss_fn(vol_coeff))
    expr = {"output": lambda out: out["output"]}
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": {"input": x[:n_train]}, "label": {"output": y[:n_train]},
                     "transforms": augmentation},
         "batch_size": batch_size, "sampler": {"shuffle": True, "drop_last": False}},
        loss, expr, name="sup_constraint")
    validator = {"topopt_val": SupervisedValidator(
        {"dataset": {"name": "NamedArrayDataset", "input": {"input": x[n_train:]}, "label": {"output": y[n_train:]}},
         "batch_size": batch_size},
        loss, expr, metric={"metrics": FunctionalMetric(val_metric)}, name="topopt_val")}
    iters_per_epoch = max(n_train // batch_size, 1)
    lr = learning_rate / (1 + epochs // 15)
    return Solver(model, {"sup_constraint": sup}, output_dir, Adam(lr, epsilon=1e-7)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, validator=validator, eval_during_train=False, seed=seed,
                  log_freq=max(iters_per_epoch, 1), device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 8)
    solver.train()
    print(f"validation: {solver.eval()[1]}")
