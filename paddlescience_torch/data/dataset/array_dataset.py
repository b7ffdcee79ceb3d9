"""Array-backed datasets (counterpart of
``paddlescience_tpu/data/dataset/array_dataset.py``).

* ``NamedArrayDataset`` is finite and indexed: a loader
  (``data/__init__.py::BatchLoader``) draws batches of rows from it, as the
  validators do;
* ``IterableNamedArrayDataset`` yields the complete arrays every step
  (full-batch training); the solver stages them on the device once.
* ``ContinuousNamedArrayDataset`` yields a fresh host batch from its
  generator functions each step; the solver stages each into the device
  buffers its captured chunk reads, as it stages indexed batches.
* ``DeviceSampledDataset`` draws a fresh batch on the device each step:
  ``sample_fn(generator) -> (input_dict, label_dict, weight_dict)`` of
  tensors, with ``generator`` a ``torch.Generator`` on the solver's device.

The host datasets take ``transforms(input, label, weight) -> (input,
label, weight)`` (``data/process/transform.py``), applied to every batch
they give, as in the JAX package: a full-batch dataset with transforms
gives a transformed copy each step, which the solver stages anew.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["NamedArrayDataset", "IterableNamedArrayDataset", "ContinuousNamedArrayDataset", "DeviceSampledDataset"]


class NamedArrayDataset:
    """Finite dataset over aligned ``{key: (N, ...)}`` arrays, indexed by
    rows; ``transforms`` maps each indexed batch."""

    batch_mode = "indexed"

    def __init__(self, input: Dict[str, np.ndarray], label: Optional[Dict[str, np.ndarray]] = None,
                 weight: Optional[Dict[str, np.ndarray]] = None, transforms=None):
        self.input = {k: np.asarray(v) for k, v in input.items()}
        self.label = {k: np.asarray(v) for k, v in (label or {}).items()}
        self.weight = {k: np.asarray(v) for k, v in (weight or {}).items()}
        self.transforms = transforms
        lens = {len(v) for v in self.input.values()}
        if len(lens) != 1:
            raise ValueError(f"input arrays must share leading dim, got {lens}")
        self._len = lens.pop()

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        inp = {k: v[idx] for k, v in self.input.items()}
        lab = {k: v[idx] for k, v in self.label.items()}
        wgt = {k: v[idx] for k, v in self.weight.items()}
        if self.transforms is not None:
            inp, lab, wgt = self.transforms(inp, lab, wgt)
        return inp, lab, wgt


class IterableNamedArrayDataset:
    """Yields the complete arrays every iteration."""

    batch_mode = "full"

    def __init__(self, input: Dict[str, np.ndarray], label: Optional[Dict[str, np.ndarray]] = None,
                 weight: Optional[Dict[str, np.ndarray]] = None, transforms=None):
        self.input = {k: np.asarray(v) for k, v in input.items()}
        self.label = {k: np.asarray(v) for k, v in (label or {}).items()}
        self.weight = {k: np.asarray(v) for k, v in (weight or {}).items()}
        self.transforms = transforms

    def __iter__(self):
        while True:
            inp, lab, wgt = self.input, self.label, self.weight
            if self.transforms is not None:
                inp, lab, wgt = self.transforms(inp, lab, wgt)
            yield inp, lab, wgt


class ContinuousNamedArrayDataset:
    """Fresh batches every step: ``input()`` gives the input dict, then
    ``label(input)`` the labels (it may pop keys that only it reads off
    the input) and ``weight(input)`` the weights."""

    batch_mode = "generator"

    def __init__(self, input: Callable[[], Dict[str, np.ndarray]],
                 label: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]], weight: Optional[Callable] = None,
                 transforms=None):
        self.input_fn = input
        self.label_fn = label
        self.weight_fn = weight
        self.transforms = transforms

    def __iter__(self):
        while True:
            inp = self.input_fn()
            lab = self.label_fn(inp)
            wgt = self.weight_fn(inp) if self.weight_fn is not None else {}
            if self.transforms is not None:
                inp, lab, wgt = self.transforms(inp, lab, wgt)
            yield inp, lab, wgt


class DeviceSampledDataset:
    """Collocation batches sampled on the device by ``sample_fn(generator)``."""

    batch_mode = "device"

    def __init__(self, sample_fn: Callable):
        self.sample_fn = sample_fn
