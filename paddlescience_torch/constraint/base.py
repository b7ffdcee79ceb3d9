"""Constraint base (counterpart of ``paddlescience_tpu/constraint/base.py``):
binds a dataset, named output expressions and a loss into one training
term."""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["Constraint"]


class Constraint:
    """``dataset`` is a ``DeviceSampledDataset`` (sampled by the solver each
    step) or a full-batch ``IterableNamedArrayDataset`` (staged once).
    ``dataloader_cfg`` keeps the JAX signature; neither kind reads it."""

    def __init__(self, dataset, dataloader_cfg: Optional[Dict[str, Any]], loss, name: str):
        mode = getattr(dataset, "batch_mode", None)
        if mode not in ("device", "full"):
            raise NotImplementedError(
                f"constraint '{name}': only device-sampled and full-batch datasets are ported, "
                f"got {type(dataset).__name__}"
            )
        self.dataset = dataset
        self.loss = loss
        self.name = name
        self.data_iter = None if mode == "device" else iter(dataset)
