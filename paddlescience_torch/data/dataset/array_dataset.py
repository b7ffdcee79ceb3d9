"""Array-backed datasets (counterpart of
``paddlescience_tpu/data/dataset/array_dataset.py``).

* ``IterableNamedArrayDataset`` yields the complete arrays every step
  (full-batch training); the solver stages them on the device once.
* ``DeviceSampledDataset`` draws a fresh batch on the device each step:
  ``sample_fn(generator) -> (input_dict, label_dict, weight_dict)`` of
  tensors, with ``generator`` a ``torch.Generator`` on the solver's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["IterableNamedArrayDataset", "DeviceSampledDataset"]


class IterableNamedArrayDataset:
    """Yields the complete arrays every iteration."""

    batch_mode = "full"

    def __init__(self, input: Dict[str, np.ndarray], label: Optional[Dict[str, np.ndarray]] = None,
                 weight: Optional[Dict[str, np.ndarray]] = None):
        self.input = {k: np.asarray(v) for k, v in input.items()}
        self.label = {k: np.asarray(v) for k, v in (label or {}).items()}
        self.weight = {k: np.asarray(v) for k, v in (weight or {}).items()}

    def __iter__(self):
        while True:
            yield self.input, self.label, self.weight


class DeviceSampledDataset:
    """Collocation batches sampled on the device by ``sample_fn(generator)``."""

    batch_mode = "device"

    def __init__(self, sample_fn: Callable):
        self.sample_fn = sample_fn
