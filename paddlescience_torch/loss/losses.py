"""Losses (counterpart of ``paddlescience_tpu/loss/losses.py``): every
class of the JAX package. Contract (``loss/base.py``):
``loss(output_dict, label_dict, weight_dict=None) -> {key: scalar}``. As in
the JAX package, a pointwise loss is weighted by the ``"area"`` column
when the output dict carries one (mesh boundary samples do); the periodic
losses compare the first half of the batch with the second (a
``PeriodicConstraint``'s points and their images)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from paddlescience_torch.loss.base import Loss

__all__ = ["Loss", "MSELoss", "CausalMSELoss", "MSELossWithL2Decay", "L1Loss", "PeriodicL1Loss", "L2Loss",
           "PeriodicL2Loss", "L2RelLoss", "MAELoss", "KLLoss", "ChamferLoss", "IntegralLoss", "FunctionalLoss"]


def _elementwise(output_dict, label_dict, weight_dict, key, fn):
    loss = fn(output_dict[key], label_dict[key])
    if weight_dict and key in weight_dict:
        loss = loss * weight_dict[key]
    if "area" in output_dict:
        loss = loss * output_dict["area"]
    return loss


def _squared_error(output_dict, label_dict, weight_dict, key):
    return _elementwise(output_dict, label_dict, weight_dict, key, lambda o, lab: (o - lab) ** 2)


class MSELoss(Loss):
    """Mean squared error."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        return {key: self._apply_weight(self._reduce(_squared_error(output_dict, label_dict, weight_dict, key)), key)
                for key in label_dict}


class MSELossWithL2Decay(MSELoss):
    """MSE plus, for each key of ``regularization_dict``, factor * sum(out^2)
    of that output field."""

    def __init__(self, reduction: str = "mean", regularization_dict: Optional[Dict[str, float]] = None,
                 weight=None):
        super().__init__(reduction, weight)
        self.regularization_dict = regularization_dict

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = super().__call__(output_dict, label_dict, weight_dict)
        for reg_key, reg_factor in (self.regularization_dict or {}).items():
            losses[reg_key] = losses.get(reg_key, 0.0) + reg_factor * torch.sum(output_dict[reg_key] ** 2)
        return losses


class L1Loss(Loss):
    """Absolute error, weighted and reduced."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        return {key: self._apply_weight(self._reduce(
            _elementwise(output_dict, label_dict, weight_dict, key, lambda o, lab: torch.abs(o - lab))), key)
            for key in label_dict}


class MAELoss(L1Loss):
    """Mean absolute error (the same as :class:`L1Loss`, as in JAX)."""


def _halves(output_dict, key):
    n = output_dict[key].shape[0]
    if n % 2 > 0:
        raise ValueError(f"batch size of key({key}) must be even for periodic loss, got {n}")
    return output_dict[key][: n // 2], output_dict[key][n // 2 :], n // 2


class PeriodicL1Loss(Loss):
    """|first half - second half| of each output (periodic pairs), times
    the weight and the first half's area."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            lhs, rhs, half = _halves(output_dict, key)
            loss = torch.abs(lhs - rhs)
            if weight_dict and key in weight_dict:
                loss = loss * weight_dict[key]
            if "area" in output_dict:
                loss = loss * output_dict["area"][:half]
            losses[key] = self._apply_weight(self._reduce(loss), key)
        return losses


class L2Loss(Loss):
    """Per-sample L2 norm of the (weighted) error vector, times the area,
    reduced over the batch."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            err = output_dict[key] - label_dict[key]
            if weight_dict and key in weight_dict:
                err = err * weight_dict[key]
            loss = torch.linalg.vector_norm(err, dim=-1)
            if "area" in output_dict:
                loss = loss * output_dict["area"][..., 0]
            losses[key] = self._apply_weight(self._reduce(loss), key)
        return losses


class PeriodicL2Loss(Loss):
    """Per-sample L2 norm of first half - second half."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            lhs, rhs, _ = _halves(output_dict, key)
            losses[key] = self._apply_weight(self._reduce(torch.linalg.vector_norm(lhs - rhs, dim=-1)), key)
        return losses


class KLLoss(Loss):
    """KL(softmax(label) || softmax(output)) along the last axis."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            logp = torch.log_softmax(output_dict[key], dim=-1)
            q = torch.softmax(label_dict[key], dim=-1)
            loss = torch.sum(q * (torch.log(q + 1e-12) - logp), dim=-1)
            losses[key] = self._apply_weight(self._reduce(loss), key)
        return losses


class ChamferLoss(Loss):
    """Symmetric Chamfer distance between point sets (B, N, D) and (B, M, D)."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            o, lab = output_dict[key], label_dict[key]
            d2 = torch.sum((o[:, :, None, :] - lab[:, None, :, :]) ** 2, dim=-1)  # (B, N, M)
            loss = d2.min(dim=2).values.mean(dim=1) + d2.min(dim=1).values.mean(dim=1)
            losses[key] = self._apply_weight(self._reduce(loss), key)
        return losses


class CausalMSELoss(Loss):
    """Temporal-causality weighted MSE: the time-sorted residual batch is
    reshaped to (n_chunks, -1); chunk i is weighted
    w_i = exp(-tol * sum_{k<i} mean L_k), detached."""

    def __init__(self, n_chunks: int, reduction: str = "mean",
                 weight: Optional[Union[float, Dict[str, float]]] = None, tol: float = 1.0):
        if n_chunks <= 0:
            raise ValueError(f"n_chunks should be positive, but got {n_chunks}")
        super().__init__(reduction, weight)
        self.n_chunks = n_chunks
        self.tol = tol

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            loss_t = _squared_error(output_dict, label_dict, weight_dict, key).reshape(self.n_chunks, -1)
            # strictly-lower-triangular accumulation, as a product like the
            # JAX package (acc_mat @ chunk means)
            acc = torch.tril(torch.ones(self.n_chunks, self.n_chunks, device=loss_t.device), -1)
            weight_t = torch.exp(-self.tol * (acc @ loss_t.mean(dim=-1, keepdim=True)))
            losses[key] = self._apply_weight(self._reduce(loss_t * weight_t.detach()), key)
        return losses


class IntegralLoss(Loss):
    """Monte-Carlo integral matching: per set of points, (sum_i o_i * area_i
    - label)^2, times the weight, reduced over the sets. Outputs and areas
    are (sets, points, 1), labels and weights (sets, 1)."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            integral = (output_dict[key] * output_dict["area"]).sum(dim=1)
            loss = (integral - label_dict[key]) ** 2
            if weight_dict and key in weight_dict:
                loss = loss * weight_dict[key]
            losses[key] = self._apply_weight(self._reduce(loss), key)
        return losses


class L2RelLoss(Loss):
    """Per-sample relative L2, ||o - l|| / (||l|| + 1e-12) over each
    sample's flattened entries, times the weight, reduced over the batch."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        losses = {}
        for key in label_dict:
            o = output_dict[key].reshape(output_dict[key].shape[0], -1)
            lab = label_dict[key].reshape(label_dict[key].shape[0], -1)
            rel = torch.linalg.vector_norm(o - lab, dim=-1) / (torch.linalg.vector_norm(lab, dim=-1) + 1e-12)
            if weight_dict and key in weight_dict:
                rel = rel * weight_dict[key]
            losses[key] = self._apply_weight(self._reduce(rel), key)
        return losses


class FunctionalLoss(Loss):
    """A user function ``(output_dict, label_dict, weight_dict) -> {key:
    scalar}`` (a bare scalar becomes ``{"loss": scalar}``). ``weight`` is
    kept as the JAX class keeps it: the function's result is returned as
    it is, unscaled (a weight belongs inside the function)."""

    def __init__(self, loss_expr: Callable, weight=None):
        super().__init__("mean", weight)
        self.loss_expr = loss_expr

    def __call__(self, output_dict, label_dict=None, weight_dict=None) -> Dict[str, torch.Tensor]:
        result = self.loss_expr(output_dict, label_dict, weight_dict)
        return result if isinstance(result, dict) else {"loss": result}
