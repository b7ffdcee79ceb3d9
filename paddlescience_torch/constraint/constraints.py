"""Constraints (counterpart of
``paddlescience_tpu/constraint/constraints.py``). Ported:
``SupervisedConstraint`` in its dict-config form over an
``IterableNamedArrayDataset``."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.data.dataset.array_dataset import IterableNamedArrayDataset

__all__ = ["SupervisedConstraint"]

_DATASETS = {"IterableNamedArrayDataset": IterableNamedArrayDataset}


class SupervisedConstraint(Constraint):
    """Data-driven constraint over a configured dataset:
    ``{"dataset": {"name": ..., "input": {...}, "label": {...}}}``."""

    def __init__(self, dataloader_cfg: Dict[str, Any], loss,
                 output_expr: Optional[Dict[str, Callable]] = None, name: str = "Sup"):
        ds_cfg = dict(dataloader_cfg["dataset"])
        ds_name = ds_cfg.pop("name")
        if ds_name not in _DATASETS:
            raise NotImplementedError(f"dataset '{ds_name}' is not ported; available: {sorted(_DATASETS)}")
        dataset = _DATASETS[ds_name](**ds_cfg)
        self.input_keys = tuple(dataset.input.keys())
        self.output_keys = tuple(output_expr.keys()) if output_expr is not None else tuple(dataset.label.keys())
        if output_expr is None:
            output_expr = {key: (lambda out, k=key: out[k]) for key in self.output_keys}
        self.output_expr = output_expr
        super().__init__(dataset, dataloader_cfg, loss, name)
