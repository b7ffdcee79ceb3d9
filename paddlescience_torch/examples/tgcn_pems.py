"""TGCN traffic-flow forecasting on PEMS, on the port (counterpart of
``examples/tgcn_pems.py``; reference ``examples/tgcn/run.py``).

``TGCN`` (dilated temporal convolutions and K-hop graph convolutions over
a ring adjacency of ``num_nodes`` sensors) predicts the next 12 readings
from a 12-step window. The data are ``PEMSDataset``'s synthetic
daily-periodic series (inputs standard-scaled, labels raw), given a
channel axis by the ``AddChannel`` dataset transform. The recipe is the
reference config's (``examples/tgcn/conf/run.yaml``): L1 loss, Adam at
0.01, batch 64 (shuffled, the short last dropped), emb 32 / hidden 64,
gc_layer 2, tc_layer 2, k_s 3, dropout 0.25 (drawn from the solver's
generator in train steps, off in eval), the MAE/RMSE validator every 10
epochs. ``num_nodes`` defaults to the JAX example's 16; PEMSD4 has 307
sensors.

Run on the GPU: ``python -m paddlescience_torch.examples.tgcn_pems
[epochs] [num_nodes]``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.graph_nets import TGCN
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import L1Loss
from paddlescience_torch.metric import MAE, RMSE
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["NUM_NODES", "IN_LEN", "LABEL_LEN", "AddChannel", "ring_adjacency", "build_solver"]

NUM_NODES, IN_LEN, LABEL_LEN = 16, 12, 12


class AddChannel:
    """(B, T, N) -> (B, T, N, 1) for both input and label (a dataset
    transform)."""

    def __call__(self, inp, lab, wgt):
        x = np.asarray(inp["input"])[..., None]
        y = np.asarray(lab["label"])[..., None]
        return {"input": x}, {"label": y}, wgt


def ring_adjacency(num_nodes: int) -> np.ndarray:
    """Each sensor linked to its ring neighbours, both ways."""
    adj = np.zeros((num_nodes, num_nodes), np.float32)
    for i in range(num_nodes):
        adj[i, (i + 1) % num_nodes] = adj[(i + 1) % num_nodes, i] = 1.0
    return adj


def build_solver(epochs: int = 100, output_dir: Optional[str] = "./output_tgcn_pems", num_steps: int = 2880,
                 batch_size: int = 64, learning_rate: float = 0.01, num_nodes: int = NUM_NODES, *,
                 device: DeviceLike = None) -> Solver:
    """The JAX example's solver over ``num_nodes`` sensors."""
    device = resolve_device(device)
    np.random.seed(3407)  # the reference run.yaml seed
    model = TGCN(("input",), ("label",), adj=ring_adjacency(num_nodes), in_dim=1, emb_dim=32, hidden=64,
                 gc_layer=2, tc_layer=2, k_s=3, dropout=0.25, alpha=0.1, input_len=IN_LEN, label_len=LABEL_LEN,
                 generator=torch.Generator().manual_seed(3407), device=device)

    def dl(split, steps, shuffle):
        return {"dataset": {"name": "PEMSDataset", "input_keys": ("input",), "label_keys": ("label",),
                            "num_nodes": num_nodes, "input_len": IN_LEN, "label_len": LABEL_LEN, "num_steps": steps,
                            "split": split, "transforms": AddChannel()},
                "batch_size": batch_size, "sampler": {"shuffle": shuffle, "drop_last": shuffle}}

    sup = SupervisedConstraint(dl("train", num_steps, True), L1Loss("mean"), {"label": lambda out: out["label"]},
                               name="Sup")
    validator = SupervisedValidator(dl("val", max(num_steps // 5, 4 * (IN_LEN + LABEL_LEN)), False),
                                    L1Loss("mean"), metric={"MAE": MAE(), "RMSE": RMSE()}, name="pems_valid")
    iters = max((num_steps - IN_LEN - LABEL_LEN + 1) // batch_size, 1)
    return Solver(model, {"Sup": sup}, output_dir, Adam(learning_rate)(model), epochs=epochs, iters_per_epoch=iters,
                  validator={"pems_valid": validator}, eval_during_train=True, eval_freq=10, log_freq=50,
                  device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 100, num_nodes=int(argv[1]) if len(argv) > 1 else NUM_NODES)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final val MAE = {solver.eval()[0]:.4f}")
