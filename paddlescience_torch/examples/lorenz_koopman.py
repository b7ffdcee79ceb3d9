"""The Lorenz Koopman embedding, on the port (counterpart of
``examples/lorenz_koopman.py``).

``LorenzEmbedding`` (3 -> 128 -> 32 encoder and decoder, inputs
normalised by the data's mean and deviation) learns encode, advance by
the learned Koopman matrix, decode, on 64 RK4 trajectories of 256 steps
(:func:`make_lorenz_data`, the JAX example's numpy draw) cut into 960
windows of 16; batches of 256 (shuffled), 8 steps an epoch; the loss 10
x reconstruction MSE + one-step prediction MSE + 0.01 x mean(K^2); Adam
with exponential decay 0.995 an epoch. The validator scores the
one-step prediction MSE on the last eighth of the windows.

Run on the GPU: ``python -m paddlescience_torch.examples.lorenz_koopman
[epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.embedding_koopman import LorenzEmbedding
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss
from paddlescience_torch.metric import FunctionalMetric
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["make_lorenz_data", "koopman_loss", "build_solver"]


def make_lorenz_data(n_traj: int = 64, T: int = 256, dt: float = 0.01, seed: int = 0) -> np.ndarray:
    """(n_traj, T, 3) float32 RK4 trajectories from uniform starts."""
    rng = np.random.default_rng(seed)

    def rhs(s):
        x, y, z = s[..., 0], s[..., 1], s[..., 2]
        return np.stack([10.0 * (y - x), x * (28.0 - z) - y, x * y - (8.0 / 3.0) * z], axis=-1)

    s = rng.uniform(-15, 15, size=(n_traj, 3))
    s[:, 2] += 25
    out = []
    for _ in range(T):
        k1 = rhs(s)
        k2 = rhs(s + dt / 2 * k1)
        k3 = rhs(s + dt / 2 * k2)
        k4 = rhs(s + dt * k3)
        s = s + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(s.copy())
    return np.stack(out, axis=1).astype(np.float32)


def koopman_loss(output_dict, label_dict, weight_dict=None):
    states = label_dict["states"]
    loss_rec = torch.mean((output_dict["recover_states"] - states) ** 2)
    loss_pred = torch.mean((output_dict["pred_states"] - states[:, 1:]) ** 2)
    loss_k = 0.01 * torch.mean(output_dict["k_matrix"] ** 2)
    return {"koopman": 10.0 * loss_rec + loss_pred + loss_k}


def _pred_mse(output_dict, label_dict):
    return {"pred_MSE": torch.mean((output_dict["pred_states"] - label_dict["states"][:, 1:]) ** 2)}


def build_solver(epochs: int = 50, iters_per_epoch: int = 8, seq_len: int = 16,
                 output_dir: Optional[str] = "./output_lorenz_enn", *, device: DeviceLike = None) -> Solver:
    """The JAX example's solver."""
    device = resolve_device(device)
    np.random.seed(42)
    random.seed(42)
    data = make_lorenz_data()
    mean, std = data.mean((0, 1)), data.std((0, 1))
    windows = np.concatenate([data[:, i: i + seq_len] for i in range(0, data.shape[1] - seq_len, seq_len)], axis=0)
    model = LorenzEmbedding(("states",), ("pred_states", "recover_states", "k_matrix"), mean=tuple(mean.tolist()),
                            std=tuple(std.tolist()), input_size=3, hidden_size=128, embed_size=32,
                            generator=torch.Generator().manual_seed(42), device=device)
    expr = {k: (lambda out, kk=k: out[kk]) for k in model.output_keys}
    sup = SupervisedConstraint({"dataset": {"name": "NamedArrayDataset", "input": {"states": windows},
                                            "label": {"states": windows}},
                                "batch_size": 256, "sampler": {"shuffle": True}},
                               FunctionalLoss(koopman_loss), expr, name="Sup")
    val_windows = windows[-max(len(windows) // 8, 1):]  # the training constraint keeps every window, as in JAX
    validator = SupervisedValidator({"dataset": {"name": "NamedArrayDataset", "input": {"states": val_windows},
                                                 "label": {"states": val_windows}}, "batch_size": 256},
                                    FunctionalLoss(koopman_loss), expr,
                                    metric={"pred_MSE": FunctionalMetric(_pred_mse)}, name="koopman_val")
    lr = ExponentialDecay(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=1e-3, gamma=0.995,
                          decay_steps=iters_per_epoch)()
    return Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  validator={"koopman_val": validator}, log_freq=100, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final pred MSE = {solver.eval()[0]:.4e}")
