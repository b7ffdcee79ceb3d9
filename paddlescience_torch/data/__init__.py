"""Data layer (counterpart of ``paddlescience_tpu/data/__init__.py``):
array datasets and the host batch loader the validators read.

``BatchLoader`` walks an indexed dataset in batches of rows, as the JAX
package's does for one process: ``drop_last`` drops the short last batch
(or keeps it), ``shuffle`` draws a new permutation each pass from an
explicit ``torch.Generator``. Full-batch datasets yield their arrays whole, generator datasets a fresh
batch each step.

A dataset config's ``transforms`` (a list of ``{"name": ..., **kwargs}``)
is compiled by ``data/process/transform.py::build_transforms`` (a callable
is kept as it is) and applied to every sample batch the dataset gives; a
loader's ``batch_transforms`` (``[{"FunctionalBatchTransform":
{"transform_func": f}}, ...]`` or a callable) to every batch it yields,
as the JAX package's. The multi-process shard is not ported.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.data.dataset import (CGCNNDataset, ChipHeatDataset, ContinuousNamedArrayDataset,
                                              CylinderDataset, DeviceSampledDataset, ENSODataset, ERA5Dataset,
                                              ERA5SampledDataset, ExtMoEENSODataset, FWIDataset, GridMeshAtmosphericDataset,
                                              IterableNamedArrayDataset, LorenzDataset, MeshAirfoilDataset,
                                              MeshCylinderDataset, NamedArrayDataset, PEMSDataset, RosslerDataset,
                                              SEVIRDataset, SphericalSWEDataset)
from paddlescience_torch.data.process.transform import Compose, build_transforms

__all__ = ["BatchLoader", "build_dataset", "build_dataloader", "build_batch_transforms", "FunctionalBatchTransform", "Compose", "build_transforms", "ContinuousNamedArrayDataset",
           "DeviceSampledDataset", "ERA5Dataset", "ERA5SampledDataset", "FWIDataset", "IterableNamedArrayDataset",
           "NamedArrayDataset", "SphericalSWEDataset", "ENSODataset", "ExtMoEENSODataset", "SEVIRDataset",
           "LorenzDataset", "RosslerDataset", "CylinderDataset", "PEMSDataset", "MeshAirfoilDataset",
           "MeshCylinderDataset", "GridMeshAtmosphericDataset", "CGCNNDataset", "ChipHeatDataset"]

_DATASETS = {
    "NamedArrayDataset": NamedArrayDataset,
    "IterableNamedArrayDataset": IterableNamedArrayDataset,
    "ContinuousNamedArrayDataset": ContinuousNamedArrayDataset,
    "DeviceSampledDataset": DeviceSampledDataset,
    "ERA5Dataset": ERA5Dataset,
    "ERA5SampledDataset": ERA5SampledDataset,
    "FWIDataset": FWIDataset,
    "SphericalSWEDataset": SphericalSWEDataset,
    "ENSODataset": ENSODataset,
    "ExtMoEENSODataset": ExtMoEENSODataset,
    "SEVIRDataset": SEVIRDataset,
    "LorenzDataset": LorenzDataset,
    "RosslerDataset": RosslerDataset,
    "CylinderDataset": CylinderDataset,
    "PEMSDataset": PEMSDataset,
    "MeshAirfoilDataset": MeshAirfoilDataset,
    "MeshCylinderDataset": MeshCylinderDataset,
    "GridMeshAtmosphericDataset": GridMeshAtmosphericDataset,
    "CGCNNDataset": CGCNNDataset,
    "ChipHeatDataset": ChipHeatDataset,
}


def build_dataset(cfg):
    """A dataset from ``{"name": ..., **kwargs}``; a ``transforms`` config
    that is not callable is compiled with :func:`build_transforms`. The
    config's arrays are handed over, not copied."""
    cfg = dict(cfg)
    name = cfg.pop("name")
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset '{name}', available: {sorted(_DATASETS)}")
    if cfg.get("transforms") is not None and not callable(cfg["transforms"]):
        cfg["transforms"] = build_transforms(cfg["transforms"])
    return _DATASETS[name](**cfg)


class BatchLoader:
    """Endless iterator of ``(input, label, weight)`` numpy dict batches.

    An indexed dataset is walked in ``len(self)`` batches a pass of
    ``batch_size`` rows (all rows when None); with ``drop_last`` the short
    last batch is dropped, otherwise yielded. With ``shuffle`` each pass
    takes a new ``torch.randperm`` from ``generator`` (a CPU generator
    seeded with ``seed`` when None). ``batch_transforms(input, label,
    weight)``, when given, maps every indexed batch before it is yielded."""

    def __init__(self, dataset, batch_size: Optional[int] = None, shuffle: bool = False, drop_last: bool = True,
                 seed: int = 42, generator: Optional[torch.Generator] = None,
                 batch_transforms: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.batch_transforms = batch_transforms
        self.generator = generator if generator is not None else torch.Generator().manual_seed(seed)
        if getattr(dataset, "batch_mode", "indexed") == "indexed":
            n = len(dataset)
            if batch_size is None:
                self.batch_size = n
            self.num_batches = max(n // self.batch_size, 1) if drop_last else -(-n // self.batch_size)
        else:
            self.num_batches = 1

    def __len__(self):
        return self.num_batches

    def __iter__(self) -> Iterator[Tuple[Dict, Dict, Dict]]:
        mode = getattr(self.dataset, "batch_mode", "indexed")
        if mode in ("full", "generator"):
            yield from iter(self.dataset)
            return
        if mode == "device":
            raise TypeError("DeviceSampledDataset has no host loader; the solver samples it in-step")
        n = len(self.dataset)
        while True:
            idx = torch.randperm(n, generator=self.generator).numpy() if self.shuffle else np.arange(n)
            for b in range(self.num_batches):  # fewer rows than a batch: one short batch, drop_last or not
                batch = self.dataset[idx[b * self.batch_size: (b + 1) * self.batch_size]]
                if self.batch_transforms is not None:
                    batch = self.batch_transforms(*batch)
                yield batch


class FunctionalBatchTransform:
    """A user function of the assembled ``(input, label, weight)`` batch."""

    def __init__(self, transform_func: Callable):
        self.transform_func = transform_func

    def __call__(self, inp, lab, wgt):
        return self.transform_func(inp, lab, wgt)


def build_batch_transforms(cfg) -> Optional[Callable]:
    """``[{name: {kwargs}}, ...]`` -> one callable over ``(input, label,
    weight)`` applying them in order (None for an empty config; a callable
    is returned as it is). The only name is ``FunctionalBatchTransform``."""
    if not cfg:
        return None
    if callable(cfg):
        return cfg
    fns = []
    for item in cfg:
        name = next(iter(item.keys()))
        if name != "FunctionalBatchTransform":
            raise ValueError(f"unknown batch transform '{name}'")
        fns.append(FunctionalBatchTransform(**(item[name] or {})))

    def composed(inp, lab, wgt):
        for fn in fns:
            inp, lab, wgt = fn(inp, lab, wgt)
        return inp, lab, wgt

    return composed


def build_dataloader(dataset, cfg, generator: Optional[torch.Generator] = None) -> BatchLoader:
    """``cfg``: ``{"batch_size": int, "sampler": {"shuffle", "drop_last"},
    "seed": int, "batch_transforms": [...]}`` as in the JAX package
    (``drop_last`` True unless given)."""
    cfg = copy.deepcopy(dict(cfg or {}))
    sampler = dict(cfg.get("sampler", {}))
    return BatchLoader(dataset, batch_size=cfg.get("batch_size"), shuffle=sampler.get("shuffle", False),
                       drop_last=sampler.get("drop_last", True), seed=cfg.get("seed", 42), generator=generator,
                       batch_transforms=build_batch_transforms(cfg.get("batch_transforms")))
