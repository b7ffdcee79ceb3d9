"""Transformer-PhysX on the Lorenz system, on the port (counterpart of
``examples/physformer_lorenz.py``).

Stage 1 (:class:`EmbeddingPretrain`) trains ``LorenzEmbedding`` (3 -> 64
-> 32) for 60 full-batch Adam steps (1e-3) on every ``LorenzDataset``
window (16 steps, stride 8, 8 RK4 trajectories), the loss the one-step
prediction MSE + 10 x the reconstruction MSE: a hand loop whose steps run
in one CUDA graph per chunk on the card (``utils/step_graph.py``), as the
JAX example jits its optax step. Stage 2 (:func:`build_solver`) trains
``PhysformerGPT2`` (2 layers, 4 heads, context 16) on the stage-1
encoder's embeddings of the windows through the ``Solver``: batches of 8
(shuffled), 4 steps an epoch, next-embedding MSE, Adam on a cosine
schedule at 1e-3.

Run on the GPU: ``python -m paddlescience_torch.examples.physformer_lorenz
[epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.embedding_koopman import LorenzEmbedding
from paddlescience_torch.arch.physx_transformer import PhysformerGPT2
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.data.dataset.domain_dataset import LorenzDataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import HandLoop
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import MSE
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["EMBED", "BLOCK", "EmbeddingPretrain", "build_solver"]

EMBED, BLOCK = 32, 16


class EmbeddingPretrain(HandLoop):
    """The stage-1 embedding, its windows on the device and its Adam step."""

    def __init__(self, *, device: DeviceLike = None):
        device = resolve_device(device)
        self.model = LorenzEmbedding(("states",), ("pred_states", "recover_states"), input_size=3, hidden_size=64,
                                     embed_size=EMBED, generator=torch.Generator().manual_seed(0), device=device)
        ds = LorenzDataset(None, ("states",), ("pred_states", "recover_states"), block_size=BLOCK, stride=8, ndata=8)
        self.data = torch.from_numpy(ds.input["states"]).to(device)
        self.optimizer = Adam(1e-3)(self.model)
        self.modules, self.optimizers = [self.model], [self.optimizer]
        self._start_loop(device)

    def loss(self) -> torch.Tensor:
        out = self.model({"states": self.data})
        mse1 = torch.mean((out["pred_states"] - self.data[:, 1:]) ** 2)
        return mse1 + 10.0 * torch.mean((out["recover_states"] - self.data) ** 2)

    def train(self, steps: int = 60, k: int = 1) -> float:
        """``steps`` Adam steps in chunks of ``k`` (one graph a chunk on
        the card when k > 1); returns the last step's loss (taken before
        its update, as the JAX step reports it)."""
        return self.train_steps(steps, k)["loss"]


def build_solver(epochs: int = 4, output_dir: Optional[str] = "./output_physformer_lorenz", embedding_model=None,
                 *, device: DeviceLike = None) -> Solver:
    """The JAX example's stage-2 solver (stage 1 first, its 60 steps in
    one chunk, when no ``embedding_model`` is given)."""
    device = resolve_device(device)
    np.random.seed(0)
    random.seed(0)
    if embedding_model is None:
        stage1 = EmbeddingPretrain(device=device)
        print(f"stage-1 embedding loss: {stage1.train(60, 60):.4f}")
        embedding_model = stage1.model
    model = PhysformerGPT2(("embeds",), ("pred_embeds",), num_layers=2, num_ctx=BLOCK, embed_size=EMBED, num_heads=4,
                           generator=torch.Generator().manual_seed(0), device=device)
    dl = {"dataset": {"name": "LorenzDataset", "file_path": None, "input_keys": ("embeds",),
                      "label_keys": ("pred_embeds",), "block_size": BLOCK, "stride": 8, "ndata": 8,
                      "embedding_model": embedding_model},
          "batch_size": 8, "sampler": {"shuffle": True, "drop_last": True}}
    expr = {"pred_embeds": lambda out: out["pred_embeds"][:, :-1]}
    sup = SupervisedConstraint(dl, MSELoss("mean"), expr, name="Sup")
    validator = SupervisedValidator(dict(dl, sampler={"shuffle": False, "drop_last": False}), MSELoss("mean"),
                                    output_expr=expr, metric={"MSE": MSE()}, name="lorenz_valid")
    lr = Cosine(epochs=epochs, iters_per_epoch=4, learning_rate=1e-3)()
    return Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=4,
                  validator={"lorenz_valid": validator}, eval_during_train=False, log_freq=4, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 4)
    solver.train()
    print(f"final MSE = {solver.eval()[0]:.4e}")
