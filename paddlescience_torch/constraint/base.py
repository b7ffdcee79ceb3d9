"""Constraint base (counterpart of ``paddlescience_tpu/constraint/base.py``):
binds a dataset, named output expressions and a loss into one training
term."""

from __future__ import annotations

from typing import Any, Dict, Optional

from paddlescience_torch import data as data_mod

__all__ = ["Constraint"]


class Constraint:
    """``dataset`` is a ``DeviceSampledDataset`` (sampled by the solver each
    step), a full-batch ``IterableNamedArrayDataset`` (staged once) or an
    indexed ``NamedArrayDataset``, walked by a ``BatchLoader`` built from
    ``dataloader_cfg`` (``batch_size``, ``sampler`` shuffle and drop_last,
    ``seed``) as in the JAX package: the solver draws a new batch from it
    each step."""

    def __init__(self, dataset, dataloader_cfg: Optional[Dict[str, Any]], loss, name: str):
        mode = getattr(dataset, "batch_mode", "indexed")
        self.dataset = dataset
        self.loss = loss
        self.name = name
        self.data_loader = None
        if mode == "device":
            self.data_iter = None
        elif mode == "full":
            self.data_iter = iter(dataset)
        else:
            self.data_loader = data_mod.build_dataloader(dataset, dataloader_cfg)
            self.data_iter = iter(self.data_loader)
