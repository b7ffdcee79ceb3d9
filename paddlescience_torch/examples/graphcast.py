"""GraphCast weather GNN, on the port (counterpart of
``examples/graphcast.py``; reference ``examples/graphcast/graphcast.py``).

``GraphCastNet`` (grid2mesh encoder, processor over the union of every
refinement level of an icosahedral multi-mesh, mesh2grid decoder; hidden
64, 4 layers, ``mesh_level`` 2) fits ``GridMeshAtmosphericDataset``'s 6
synthetic lat 8 x lon 16 grids of 8 channels to their next state: Adam at
1e-3 on the mean squared error of one sample a step, in turn
(``graph_fit.GraphFit``); the loss must fall. The score is the per-node
RMSE averaged over the samples (the reference's metric).

Run on the GPU: ``python -m paddlescience_torch.examples.graphcast
[steps]``.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.graph_nets import GraphCastNet
from paddlescience_torch.data import build_dataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.graph_fit import GraphFit

__all__ = ["build", "rmse", "fit"]


def build(lat: int = 8, lon: int = 16, hidden: int = 64, n_layers: int = 4, lr: float = 1e-3,
          num_samples: int = 6, data_dir: Optional[str] = None, mesh_level: int = 2, *,
          device: DeviceLike = None) -> GraphFit:
    device = resolve_device(device)
    np.random.seed(0)
    ds = build_dataset({"name": "GridMeshAtmosphericDataset", "input_keys": ("input",), "label_keys": ("label",),
                        "data_dir": data_dir, "num_samples": num_samples, "lat": lat, "lon": lon})
    model = GraphCastNet(("grid",), ("pred",), node_in_dim=8, out_dim=8, hidden=hidden, n_layers=n_layers, lat=lat,
                         lon=lon, mesh_level=mesh_level, generator=torch.Generator().manual_seed(0), device=device)
    samples = [({"grid": torch.as_tensor(ds[i][0]["input"][0], device=device)},
                torch.as_tensor(ds[i][1]["label"], device=device)) for i in range(len(ds))]
    return GraphFit(model, samples, lr, "pred", device)


@torch.no_grad()
def rmse(fit: GraphFit) -> float:
    """The per-node RMSE, averaged over the samples."""
    return float(np.mean([float(torch.sqrt(torch.mean((fit.model(inp)["pred"] - y) ** 2)))
                          for inp, y in fit.samples]))


def fit(steps: int = 60, lat: int = 8, lon: int = 16, hidden: int = 64, n_layers: int = 4, lr: float = 1e-3,
        num_samples: int = 6, data_dir: Optional[str] = None, *, device: DeviceLike = None) -> Tuple[float, GraphFit]:
    """The JAX ``_fit``: ``steps`` steps, then the RMSE; returns it and the
    fit."""
    f = build(lat, lon, hidden, n_layers, lr, num_samples, data_dir, device=device)
    first, last = f.fit(steps)
    score = rmse(f)
    print(f"GraphCast: loss {first:.4f} -> {last:.4f}; RMSE {score:.4f}")
    return score, f


if __name__ == "__main__":
    argv = sys.argv[1:]
    fit(int(argv[0]) if argv else 60)
