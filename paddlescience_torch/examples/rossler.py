"""Transformer-PhysX on the Rossler system, on the port (counterpart of
``examples/rossler.py``).

Stage 1 (:func:`train_embedding`) trains ``RosslerEmbedding`` (3 -> 64
-> 32) on ``RosslerDataset``'s RK4 windows of 16 (stride 8, 8
trajectories), MSE on the one-step prediction and the reconstruction,
Adam; stage 2 (:func:`build_transformer`) trains ``PhysformerGPT2`` (2
layers, 4 heads, context 16) on the stage-1 encoder's embeddings of the
same windows, next-embedding MSE, Adam on a cosine schedule. Batches of 8
(shuffled), 4 steps an epoch.

Run on the GPU: ``python -m paddlescience_torch.examples.rossler [epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.embedding_koopman import RosslerEmbedding
from paddlescience_torch.arch.physx_transformer import PhysformerGPT2
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["EMBED", "BLOCK", "build_embedding", "train_embedding", "build_transformer"]

EMBED, BLOCK = 32, 16


def _loader(input_keys, label_keys, ndata, iters_per_epoch, embedding_model=None):
    ds = {"name": "RosslerDataset", "file_path": None, "input_keys": input_keys, "label_keys": label_keys,
          "block_size": BLOCK, "stride": 8, "ndata": ndata}
    if embedding_model is not None:
        ds["embedding_model"] = embedding_model
    return {"dataset": ds, "batch_size": 8, "iters_per_epoch": iters_per_epoch,
            "sampler": {"shuffle": True, "drop_last": True}}


def build_embedding(epochs: int = 20, iters_per_epoch: int = 4, output_dir: Optional[str] = "./outputs_rossler",
                    ndata: int = 8, learning_rate: float = 1e-3, *, device: DeviceLike = None) -> Solver:
    """The stage-1 solver of the embedding."""
    device = resolve_device(device)
    np.random.seed(0)
    random.seed(0)
    model = RosslerEmbedding(("states",), ("pred_states", "recover_states"), input_size=3, hidden_size=64,
                             embed_size=EMBED, generator=torch.Generator().manual_seed(0), device=device)
    dl = _loader(("states",), ("pred_states", "recover_states"), ndata, iters_per_epoch)
    sup = SupervisedConstraint(dl, MSELoss("mean"), {"pred_states": lambda out: out["pred_states"],
                                                     "recover_states": lambda out: out["recover_states"]},
                               name="Sup")
    validator = SupervisedValidator(dict(dl, sampler={"shuffle": False, "drop_last": False}), MSELoss("mean"),
                                    metric={"MSE": MSE()}, name="rossler_embed_valid")
    return Solver(model, {"Sup": sup}, output_dir, Adam(learning_rate)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, validator={"rossler_embed_valid": validator},
                  eval_during_train=False, log_freq=4, device=device)


def train_embedding(epochs: int = 20, iters_per_epoch: int = 4, output_dir: Optional[str] = "./outputs_rossler",
                    ndata: int = 8, learning_rate: float = 1e-3, *, device: DeviceLike = None):
    """Stage 1: train the embedding; returns (model, metric, metric group)."""
    solver = build_embedding(epochs, iters_per_epoch, output_dir, ndata, learning_rate, device=device)
    solver.train()
    metric, group = solver.eval()
    return solver.model, metric, group


def build_transformer(embedding_model, epochs: int = 20, iters_per_epoch: int = 4,
                      output_dir: Optional[str] = "./outputs_rossler", ndata: int = 8, learning_rate: float = 1e-3,
                      *, device: DeviceLike = None) -> Solver:
    """The stage-2 solver of the transformer over ``embedding_model``'s
    embeddings."""
    device = resolve_device(device)
    model = PhysformerGPT2(("embeds",), ("pred_embeds",), num_layers=2, num_ctx=BLOCK, embed_size=EMBED,
                           num_heads=4, generator=torch.Generator().manual_seed(0), device=device)
    dl = _loader(("embeds",), ("pred_embeds",), ndata, iters_per_epoch, embedding_model)
    expr = {"pred_embeds": lambda out: out["pred_embeds"][:, :-1]}
    sup = SupervisedConstraint(dl, MSELoss("mean"), expr, name="Sup")
    validator = SupervisedValidator(dict(dl, sampler={"shuffle": False, "drop_last": False}), MSELoss("mean"),
                                    output_expr=expr, metric={"MSE": MSE()}, name="rossler_valid")
    lr = Cosine(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=learning_rate)()
    return Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  validator={"rossler_valid": validator}, eval_during_train=False, log_freq=4, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    epochs = int(argv[0]) if argv else 20
    emb, metric, _ = train_embedding(epochs=epochs)
    print(f"stage 1 MSE = {metric:.4e}")
    solver = build_transformer(emb, epochs=epochs)
    solver.train()
    print(f"stage 2 MSE = {solver.eval()[0]:.4e}")
