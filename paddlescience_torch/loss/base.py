"""Loss base class (counterpart of ``paddlescience_tpu/loss/base.py``).

Contract: ``loss(output_dict, label_dict, weight_dict=None) -> {key:
scalar}``, with the reduction over the batch (``"mean"`` or ``"sum"``), a
static weight (one number, or one per key) on each key's reduced loss,
per-sample ``weight_dict`` arrays and, for the pointwise losses, the
implicit ``output_dict["area"]`` weighting of mesh samples.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

__all__ = ["Loss"]


class Loss:
    """Base: the reduction and the static weight."""

    def __init__(self, reduction: str = "mean", weight: Optional[Union[float, Dict[str, float]]] = None):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"reduction should be 'mean' or 'sum', but got {reduction}")
        self.reduction = reduction
        self.weight = weight

    def _reduce(self, loss: torch.Tensor) -> torch.Tensor:
        return loss.sum() if self.reduction == "sum" else loss.mean()

    def _apply_weight(self, loss: torch.Tensor, key: str) -> torch.Tensor:
        if isinstance(self.weight, (float, int)):
            return loss * self.weight
        if isinstance(self.weight, dict) and key in self.weight:
            return loss * self.weight[key]
        return loss

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def __str__(self):
        return f"{self.__class__.__name__}(reduction={self.reduction}, weight={self.weight})"
