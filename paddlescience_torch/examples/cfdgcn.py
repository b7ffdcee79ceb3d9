"""CFD-GCN: a coarse-CFD-informed graph network, on the port (counterpart
of ``examples/cfdgcn.py``; reference ``examples/cfdgcn/cfdgcn.py``).

``CFDGCN``'s ``MeshGraphNet`` (hidden 64, 4 blocks) takes each node's
features with the coarse solution of :func:`potential_flow_surrogate`
(uniform flow plus a doublet, from the first two columns; the SU2 stand-in
of the JAX example) appended, on ``MeshAirfoilDataset``'s 8 graphs (files
under ``data_dir``, synthetic kNN graphs otherwise). Adam at 1e-3 on the
mean squared error of one graph a step, the graphs in turn
(``graph_fit.GraphFit``); the loss must fall.

Run on the GPU: ``python -m paddlescience_torch.examples.cfdgcn [steps]``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.graph_nets import CFDGCN
from paddlescience_torch.data import build_dataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.graph_fit import GraphFit, to_device

__all__ = ["potential_flow_surrogate", "build", "run"]


def potential_flow_surrogate(node_feats: torch.Tensor) -> torch.Tensor:
    """(u, v, p) of a uniform flow past a doublet at the origin, from the
    first two feature columns (x, y)."""
    x, y = node_feats[:, 0:1], node_feats[:, 1:2]
    r2 = x ** 2 + y ** 2 + 1e-3
    u = 1.0 - (x ** 2 - y ** 2) / r2 ** 2
    v = -2 * x * y / r2 ** 2
    p = 1.0 - (u ** 2 + v ** 2) / 2
    return torch.cat([u, v, p], dim=-1)


def build(hidden: int = 64, n_layers: int = 4, lr: float = 1e-3, num_samples: int = 8,
          data_dir: Optional[str] = None, *, device: DeviceLike = None) -> GraphFit:
    device = resolve_device(device)
    np.random.seed(0)
    ds = build_dataset({"name": "MeshAirfoilDataset", "input_keys": ("input",), "label_keys": ("label",),
                        "data_dir": data_dir, "num_samples": num_samples})
    node_dim = ds[0][0]["input"][0].shape[-1]
    edge_dim = ds[0][0]["input"][1].shape[-1]
    out_dim = ds[0][1]["label"].shape[-1]
    model = CFDGCN(("input",), ("pred",), node_in_dim=node_dim + 3, edge_in_dim=edge_dim, out_dim=out_dim,
                   hidden=hidden, n_layers=n_layers, cfd_solver=potential_flow_surrogate,
                   generator=torch.Generator().manual_seed(0), device=device)
    samples = [({"input": to_device(ds[i][0]["input"], device, host=(2, 3))},
                torch.as_tensor(ds[i][1]["label"], device=device)) for i in range(len(ds))]
    return GraphFit(model, samples, lr, "pred", device)


def run(steps: int = 60, hidden: int = 64, n_layers: int = 4, lr: float = 1e-3, num_samples: int = 8,
        data_dir: Optional[str] = None, *, device: DeviceLike = None) -> float:
    """The JAX ``run``: ``steps`` steps; returns the last loss."""
    first, last = build(hidden, n_layers, lr, num_samples, data_dir, device=device).fit(steps)
    print(f"CFDGCN: loss {first:.4f} -> {last:.4f} over {steps} steps")
    return last


if __name__ == "__main__":
    argv = sys.argv[1:]
    run(int(argv[0]) if argv else 60)
