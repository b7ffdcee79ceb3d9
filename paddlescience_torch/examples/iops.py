"""IOPS, the industrial air-pollution type classifier, on the port
(counterpart of ``examples/iops.py``).

An MLP (3 x 64, ReLU) classifies one of four pollution types from five
monitored features (PM2.5, PM10, SO2, NO2, CO), standardised. Data: the
Excel sheet ``trainData.xlsx`` when it exists (read with pandas), else the
JAX example's Gaussian-mixture stand-in (:func:`synth_pollution`, a numpy
copy bitwise equal to it): 1000 samples, classes drawn 45/30/15/10%, a
fifth held out. Loss: cross-entropy weighted by inverse class frequency
(``FunctionalLoss``); Adam on a ``Step`` schedule (1e-3, halved every 50
epochs); shuffled batches of 32; the validator's accuracy on the held-out
fifth. The JAX example's docstring speaks of early stopping, but its
solver has none: neither has this one.

Run on the GPU: ``python -m paddlescience_torch.examples.iops [epochs]``.
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.mlp import MLP
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss
from paddlescience_torch.metric import FunctionalMetric
from paddlescience_torch.optimizer.lr_scheduler import Step
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "synth_pollution", "load_data", "xent_loss", "accuracy"]

SEED = 42  # the JAX example's set_random_seed

N_CLASSES = 4
FEATURES = ("PM2.5", "PM10", "SO2", "NO2", "CO")


def synth_pollution(n: int = 1000, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (N_CLASSES, len(FEATURES)))
    weights = np.array([0.45, 0.3, 0.15, 0.1])
    y = rng.choice(N_CLASSES, n, p=weights)
    X = centers[y] + 0.7 * rng.standard_normal((n, len(FEATURES)))
    return X.astype("float32"), y.astype("int64")


def load_data(path: Optional[str], seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    if path and osp.exists(path):
        import pandas as pd

        df = pd.read_excel(path)
        classes = sorted(df["pollution_type"].unique())
        y = df["pollution_type"].map({c: i for i, c in enumerate(classes)}).values
        return df[list(FEATURES)].values.astype("float32"), y.astype("int64")
    print(f"[iops] {path!r} absent -> synthetic pollution-type dataset")
    return synth_pollution(seed=seed)


def xent_loss(class_weights: np.ndarray):
    """The mean class-weighted negative log-likelihood of ``label``."""
    cache = {}

    def loss(out, label, weight=None):
        logits = out["output"]
        if logits.device not in cache:  # on the device once: a captured step makes no host copy
            cache[logits.device] = torch.as_tensor(class_weights, dtype=logits.dtype, device=logits.device)
        y = label["label"].to(torch.int64).reshape(-1)
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, y[:, None])[:, 0]
        return {"xent": torch.mean(cache[logits.device][y] * nll)}

    return loss


def accuracy(out, label):
    pred = torch.argmax(out["output"], dim=-1)
    return {"acc": torch.mean((pred == label["label"].reshape(-1).to(torch.int64)).to(torch.float32))}


def build_solver(epochs: int = 100, output_dir: Optional[str] = "./outputs_iops", batch_size: int = 32,
                 learning_rate: float = 1e-3, data_path: Optional[str] = "./dataset/iops/trainData.xlsx", *,
                 device: DeviceLike = None) -> Solver:
    """The IOPS solver of the JAX example (the same split and class
    weights; the weights from a ``torch.Generator`` seeded with ``SEED``)."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    X, y = load_data(data_path)
    X = (X - X.mean(0)) / (X.std(0) + 1e-9)
    idx = np.random.default_rng(42).permutation(len(X))
    n_test = len(X) // 5
    test_idx, train_idx = idx[:n_test], idx[n_test:]
    X_tr, y_tr, X_te, y_te = X[train_idx], y[train_idx], X[test_idx], y[test_idx]
    counts = np.bincount(y_tr, minlength=N_CLASSES).astype("float32")
    class_weights = len(y_tr) / (N_CLASSES * np.maximum(counts, 1.0))
    model = MLP(("input",), ("output",), 3, 64, activation="relu", input_dim=len(FEATURES), output_dim=N_CLASSES,
                generator=torch.Generator().manual_seed(SEED), device=device)
    iters = max(len(X_tr) // batch_size, 1)
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": {"input": X_tr},
                     "label": {"label": y_tr[:, None].astype("float32")}},
         "batch_size": batch_size, "iters_per_epoch": iters,
         "sampler": {"name": "BatchSampler", "drop_last": True, "shuffle": True}},
        FunctionalLoss(xent_loss(class_weights)), {"output": lambda out: out["output"]}, name="Sup")
    validator = {
        "iops_valid": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": {"input": X_te},
                         "label": {"label": y_te[:, None].astype("float32")}},
             "total_size": len(X_te), "batch_size": len(X_te),
             "sampler": {"name": "BatchSampler", "drop_last": False, "shuffle": False}},
            FunctionalLoss(xent_loss(class_weights)), {"output": lambda out: out["output"]},
            metric={"Accuracy": FunctionalMetric(accuracy)}, name="iops_valid")
    }
    lr = Step(epochs, iters, learning_rate, step_size=50, gamma=0.5)()
    return Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters,
                  eval_during_train=False, validator=validator, seed=SEED, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 100)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"iops_valid: {solver.eval()[1]['iops_valid']}")
