"""CGCNN crystal property prediction, on the port (counterpart of
``examples/cgcnn_property.py``; reference ``examples/cgcnn/cgcnn.py``).

``CrystalGraphConvNet`` (atom features 32, 2 convolutions, hidden 32)
regresses a scalar per crystal from ``CGCNNDataset``'s 16 synthetic
crystals (12 atoms, 16 atom features, 8 Gaussian distance features, 8
neighbours). All crystals are batched as one block-diagonal graph (each
crystal's neighbour indices offset by its first atom's row) and pooled per
crystal by their index arrays; Adam at 1e-3 on the mean squared error,
the same batch every step (on CUDA one captured graph of a step); the loss
must fall.

Run on the GPU: ``python -m paddlescience_torch.examples.cgcnn_property
[steps]``.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.graph_nets import CrystalGraphConvNet
from paddlescience_torch.data import build_dataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.graph_fit import GraphFit

__all__ = ["batch_crystals", "build", "main"]


def batch_crystals(ds, device) -> Tuple[Dict, torch.Tensor]:
    """Every crystal of ``ds`` as one block-diagonal graph: the input dict
    ``{"i": (atom_fea, nbr_fea, nbr_idx, crystal_atom_idx)}`` (features on
    ``device``, indices on the host) and the (n, 1) targets."""
    feats, nbrs, idxs, targets, atom_idx = [], [], [], [], []
    off = 0
    for i in range(len(ds)):
        (a, n, idx), y = ds.items[i]
        feats.append(a)
        nbrs.append(n)
        idxs.append(idx + off)
        atom_idx.append(np.arange(off, off + len(a)))
        targets.append(y)
        off += len(a)
    inp = (torch.as_tensor(np.concatenate(feats), device=device), torch.as_tensor(np.concatenate(nbrs), device=device),
           np.concatenate(idxs), atom_idx)
    return {"i": inp}, torch.as_tensor(np.asarray(targets, np.float32)[:, None], device=device)


def build(*, device: DeviceLike = None) -> GraphFit:
    device = resolve_device(device)
    np.random.seed(0)
    ds = build_dataset({"name": "CGCNNDataset", "num_samples": 16, "n_atoms": 12, "atom_fea_len": 16,
                        "nbr_fea_len": 8})
    model = CrystalGraphConvNet(orig_atom_fea_len=16, nbr_fea_len=8, atom_fea_len=32, n_conv=2, h_fea_len=32,
                                generator=torch.Generator().manual_seed(0), device=device)
    return GraphFit(model, [batch_crystals(ds, device)], 1e-3, "out", device)


def main(steps: int = 80, *, device: DeviceLike = None) -> float:
    """The JAX ``main``: ``steps`` steps; returns the last loss."""
    first, last = build(device=device).fit(steps)
    print(f"CGCNN property MSE: {first:.4f} -> {last:.4f} over {steps} steps")
    return last


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 80)
