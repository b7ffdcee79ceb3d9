"""Eval metrics (counterpart of ``paddlescience_tpu/metric/__init__.py``):
dict in, dict out, on torch tensors, with the ``keep_batch`` protocol.
Each metric computes what its JAX twin computes, in float32."""

from __future__ import annotations

import copy
from typing import Callable, Dict

import numpy as np
import torch

__all__ = [
    "Metric",
    "L2Rel",
    "MeanL2Rel",
    "MAE",
    "MSE",
    "RMSE",
    "MaxAE",
    "LatitudeWeightedACC",
    "LatitudeWeightedRMSE",
    "FunctionalMetric",
    "build_metric",
]


class Metric:
    """Base: ``metric(output_dict, label_dict) -> {key: tensor}``."""

    def __init__(self, keep_batch: bool = False):
        self.keep_batch = keep_batch

    def __call__(self, output_dict, label_dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class L2Rel(Metric):
    """||o - l||_2 / (||l||_2 + 1e-12) over the flattened arrays."""

    def __call__(self, output_dict, label_dict):
        return {
            key: torch.linalg.norm((output_dict[key] - label_dict[key]).reshape(-1))
            / (torch.linalg.norm(label_dict[key].reshape(-1)) + 1e-12)
            for key in label_dict
        }


class MeanL2Rel(Metric):
    """Per-sample relative L2, averaged over the batch (or kept per sample)."""

    def __call__(self, output_dict, label_dict):
        metrics = {}
        for key in label_dict:
            o = output_dict[key].reshape(output_dict[key].shape[0], -1)
            l = label_dict[key].reshape(label_dict[key].shape[0], -1)
            rel = torch.linalg.norm(o - l, dim=1) / (torch.linalg.norm(l, dim=1) + 1e-12)
            metrics[key] = rel if self.keep_batch else rel.mean()
        return metrics


class MAE(Metric):
    def __call__(self, output_dict, label_dict):
        metrics = {}
        for key in label_dict:
            ae = (output_dict[key] - label_dict[key]).abs()
            metrics[key] = ae.reshape(ae.shape[0], -1).mean(dim=1) if self.keep_batch else ae.mean()
        return metrics


class MSE(Metric):
    def __call__(self, output_dict, label_dict):
        metrics = {}
        for key in label_dict:
            se = (output_dict[key] - label_dict[key]) ** 2
            metrics[key] = se.reshape(se.shape[0], -1).mean(dim=1) if self.keep_batch else se.mean()
        return metrics


class RMSE(Metric):
    def __call__(self, output_dict, label_dict):
        return {key: torch.sqrt(((output_dict[key] - label_dict[key]) ** 2).mean()) for key in label_dict}


class MaxAE(Metric):
    def __call__(self, output_dict, label_dict):
        return {key: (output_dict[key] - label_dict[key]).abs().max() for key in label_dict}


def _lat_weights(num_lat: int) -> torch.Tensor:
    """cos(latitude) weights normalised to mean 1 (FourCastNet convention)."""
    w = np.cos(np.deg2rad(np.linspace(90, -90, num_lat)))
    return torch.tensor(w / np.mean(w), dtype=torch.float32)


class LatitudeWeightedACC(Metric):
    """Latitude-weighted anomaly correlation of weather fields (B, C, H=lat,
    W=lon); with ``mean``, the per-key mean is subtracted first."""

    def __init__(self, num_lat: int, keep_batch: bool = False, mean: Dict[str, np.ndarray] = None,
                 variable_dict=None):
        super().__init__(keep_batch)
        self.num_lat = num_lat
        self.mean = mean
        self.weights = _lat_weights(num_lat)[None, None, :, None]

    def __call__(self, output_dict, label_dict):
        metrics = {}
        for key in label_dict:
            o, l = output_dict[key], label_dict[key]
            if self.mean is not None and key in self.mean:
                m = torch.as_tensor(np.asarray(self.mean[key]), dtype=o.dtype, device=o.device)
                o, l = o - m, l - m
            w = self.weights.to(o.device)
            num = (w * o * l).sum(dim=(-1, -2))
            den = torch.sqrt((w * o * o).sum(dim=(-1, -2)) * (w * l * l).sum(dim=(-1, -2)))
            acc = num / (den + 1e-12)
            metrics[key] = acc if self.keep_batch else acc.mean()
        return metrics


class LatitudeWeightedRMSE(Metric):
    """Latitude-weighted RMSE over (H, W); with ``std``, scaled back by the
    per-key standard deviation."""

    def __init__(self, num_lat: int, keep_batch: bool = False, std: Dict[str, np.ndarray] = None,
                 variable_dict=None):
        super().__init__(keep_batch)
        self.weights = _lat_weights(num_lat)[None, None, :, None]
        self.std = std

    def __call__(self, output_dict, label_dict):
        metrics = {}
        for key in label_dict:
            se = (output_dict[key] - label_dict[key]) ** 2
            rmse = torch.sqrt((self.weights.to(se.device) * se).mean(dim=(-1, -2)))
            if self.std is not None and key in self.std:
                rmse = rmse * torch.as_tensor(np.asarray(self.std[key]), dtype=se.dtype, device=se.device)
            metrics[key] = rmse if self.keep_batch else rmse.mean()
        return metrics


class FunctionalMetric(Metric):
    """Wraps a user function ``(output_dict, label_dict) -> dict``."""

    def __init__(self, metric_expr: Callable, keep_batch: bool = False):
        super().__init__(keep_batch)
        self.metric_expr = metric_expr

    def __call__(self, output_dict, label_dict=None):
        return self.metric_expr(output_dict, label_dict)


def _build_one(cfg):
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name")
    cls = globals().get(name)
    if not (isinstance(cls, type) and issubclass(cls, Metric)):
        raise ValueError(f"unknown metric '{name}'")
    return cls(**cfg)


def build_metric(cfg):
    """``{"name": ..., **kwargs}`` -> a metric; a list of such -> ``{name: metric}``."""
    if isinstance(cfg, (list, tuple)):
        return {dict(item)["name"]: _build_one(item) for item in cfg}
    return _build_one(cfg)
