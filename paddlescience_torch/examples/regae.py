"""RegAE, the variational autoencoder for pressure-field compression, on
the port (counterpart of ``examples/regae.py``).

An AutoEncoder (``arch/vae.py``: 784 -> 200 -> 50, tanh) is trained on
the decoded field's MSE plus the KL term 0.5 sum(exp(2 log_sigma) + mu^2
- 1 - 2 log_sigma) / batch. Data: the NPZ key ``p_train`` when a file is
given, else the JAX example's smooth Gaussian-random-field snapshots
(:func:`synth_fields`, numpy, bitwise equal to it): 256 training and 64
validation fields of 28 x 28. Batches of 64 in order (4 steps an epoch),
Adam at 1e-3; the validator's L2Rel of the decoded fields. The noise eps
is the same at every step (``AutoEncoder``: as in the JAX module, whose
key is fixed).

Run on the GPU: ``python -m paddlescience_torch.examples.regae [epochs]``
(each epoch one CUDA graph of 4 steps).
"""

from __future__ import annotations

import os.path as osp
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.vae import AutoEncoder
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss, MSELoss
from paddlescience_torch.metric import L2Rel
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "synth_fields", "load_p", "vae_loss"]

SEED = 42  # the JAX example's set_random_seed


def synth_fields(n: int = 256, dim: int = 784, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(dim))
    k = np.fft.fftfreq(side)[:, None] ** 2 + np.fft.fftfreq(side)[None, :] ** 2
    amp = 1.0 / (1.0 + 400 * k)
    fields = []
    for _ in range(n):
        f = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((side, side))) * amp))
        fields.append(((f - f.mean()) / (f.std() + 1e-9)).reshape(-1))
    return np.stack(fields).astype("float32")


def load_p(path: Optional[str], n: int, seed: int) -> np.ndarray:
    if path and osp.exists(path):
        return np.load(path)["p_train"].astype("float32")
    print(f"[regae] {path!r} absent -> synthetic GRF pressure snapshots")
    return synth_fields(n, seed=seed)


def vae_loss(out, label, weight=None):
    mu, log_sigma = out["mu"], out["log_sigma"]
    kl = 0.5 * torch.sum(torch.exp(2.0 * log_sigma) + mu ** 2 - 1.0 - 2.0 * log_sigma) / mu.shape[0]
    return {"decode_loss": torch.mean((out["decoder_z"] - label["p_train"]) ** 2) + kl}


def build_solver(epochs: int = 200, output_dir: Optional[str] = "./outputs_regae", batch_size: int = 64,
                 learning_rate: float = 1e-3, latent_dim: int = 50, hidden_dim: int = 200,
                 train_file_path: Optional[str] = None, valid_file_path: Optional[str] = None, *,
                 device: DeviceLike = None) -> Solver:
    """The RegAE solver of the JAX example (its data bitwise; the weights
    from a ``torch.Generator`` seeded with ``SEED``)."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    p_train = load_p(train_file_path, 256, seed=0)
    p_valid = load_p(valid_file_path, 64, seed=1)
    model = AutoEncoder(("p_train",), ("mu", "log_sigma", "decoder_z"), input_dim=p_train.shape[1],
                        latent_dim=latent_dim, hidden_dim=hidden_dim, generator=torch.Generator().manual_seed(SEED),
                        device=device)
    iters = max(len(p_train) // batch_size, 1)
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": {"p_train": p_train}, "label": {"p_train": p_train}},
         "batch_size": batch_size, "iters_per_epoch": iters,
         "sampler": {"name": "BatchSampler", "drop_last": True, "shuffle": False}},
        FunctionalLoss(vae_loss), {k: (lambda out, k=k: out[k]) for k in ("mu", "log_sigma", "decoder_z")},
        name="Sup")
    validator = {
        "regae_valid": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": {"p_train": p_valid}, "label": {"decoder_z": p_valid}},
             "total_size": len(p_valid), "batch_size": len(p_valid),
             "sampler": {"name": "BatchSampler", "drop_last": False, "shuffle": False}},
            MSELoss("mean"), {"decoder_z": lambda out: out["decoder_z"]}, metric={"L2Rel": L2Rel()},
            name="regae_valid")
    }
    return Solver(model, {"Sup": sup}, output_dir, Adam(learning_rate)(model), epochs=epochs, iters_per_epoch=iters,
                  eval_during_train=False, validator=validator, seed=SEED, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 200)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"regae_valid: {solver.eval()[1]['regae_valid']}")
