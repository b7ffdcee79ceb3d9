"""AMGNet flow-field prediction on airfoil (or cylinder, ``case="cylinder"``)
meshes, on the port (counterpart of ``examples/amgnet_airfoil.py``;
reference ``examples/amgnet/amgnet_airfoil.py``).

``AMGNet`` (hidden 64, 4 message-passing blocks around a 2-block coarse
level) regresses 3 fields on each node of ``MeshAirfoilDataset``'s 8
synthetic kNN graphs (64 nodes, 4 neighbours; ``MeshCylinderDataset``'s
for the cylinder, 4 node features). Each graph's coarse level comes from
``AMGNet.coarsen`` on the host. Adam at 1e-3 on the mean squared error of
one graph a step, the graphs in turn (``graph_fit.GraphFit``: on CUDA one
captured graph per sample graph); the loss must fall.

Run on the GPU: ``python -m paddlescience_torch.examples.amgnet_airfoil
[steps] [airfoil|cylinder]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from paddlescience_torch.arch.graph_nets import AMGNet
from paddlescience_torch.data import build_dataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.graph_fit import GraphFit, to_device

__all__ = ["build", "main"]


def build(case: str = "airfoil", hidden: int = 64, n_layers: int = 4, num_samples: int = 8, *,
          device: DeviceLike = None) -> GraphFit:
    """The data (each graph with its coarse level), the model and Adam."""
    device = resolve_device(device)
    np.random.seed(0)
    ds_name = "MeshCylinderDataset" if case == "cylinder" else "MeshAirfoilDataset"
    node_dim = 4 if case == "cylinder" else 5
    ds = build_dataset({"name": ds_name, "input_keys": ("input",), "label_keys": ("label",),
                        "num_samples": num_samples})
    model = AMGNet(("input",), ("pred",), node_in_dim=node_dim, edge_in_dim=3, out_dim=3, hidden=hidden,
                   n_layers=n_layers, generator=torch.Generator().manual_seed(0), device=device)
    samples = []
    for i in range(len(ds)):
        inp, lab, _ = ds[i]
        nf, ef, s, r = inp["input"]
        assign, cs, cr = AMGNet.coarsen(s, r, len(nf))
        graph = to_device((nf, ef, s, r, assign, cs, cr), device, host=(2, 3, 4, 5, 6))
        samples.append(({"input": graph}, torch.as_tensor(lab["label"], device=device)))
    return GraphFit(model, samples, 1e-3, "pred", device)


def main(steps: int = 40, case: str = "airfoil", *, device: DeviceLike = None) -> float:
    """The JAX ``main``: ``steps`` steps; returns the last loss."""
    first, last = build(case, device=device).fit(steps)
    print(f"AMGNet {case}: loss {first:.4f} -> {last:.4f} over {steps} steps")
    return last


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 40, argv[1] if len(argv) > 1 else "airfoil")
