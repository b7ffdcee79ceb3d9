"""Losses (counterpart of ``paddlescience_tpu/loss/losses.py``):
``MSELoss``, ``CausalMSELoss``, ``IntegralLoss``, ``L2RelLoss`` and
``FunctionalLoss``. Contract:
``loss(output_dict, label_dict, weight_dict=None) -> {key: scalar}``. As in
the JAX package, a pointwise loss is weighted by the ``"area"`` column
when the output dict carries one (mesh boundary samples do)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

__all__ = ["Loss", "MSELoss", "CausalMSELoss", "IntegralLoss", "L2RelLoss", "FunctionalLoss"]


class Loss:
    """Base: the reduction over the batch and the static weight, one number
    or one per key, applied to a key's reduced loss
    (``paddlescience_tpu/loss/base.py``; ``CausalMSELoss`` and
    ``FunctionalLoss`` take none)."""

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


def _squared_error(output_dict, label_dict, weight_dict, key):
    loss = (output_dict[key] - label_dict[key]) ** 2
    if weight_dict and key in weight_dict:
        loss = loss * weight_dict[key]
    if "area" in output_dict:
        loss = loss * output_dict["area"]
    return loss


class MSELoss(Loss):
    """Mean squared error."""

    def __call__(self, output_dict, label_dict, weight_dict=None) -> Dict[str, torch.Tensor]:
        return {key: self._apply_weight(self._reduce(_squared_error(output_dict, label_dict, weight_dict, key)), key)
                for key in label_dict}


class CausalMSELoss(Loss):
    """Temporal-causality weighted MSE: the time-sorted residual batch is
    reshaped to (n_chunks, -1); chunk i is weighted
    w_i = exp(-tol * sum_{k<i} mean L_k), detached."""

    def __init__(self, n_chunks: int, reduction: str = "mean", tol: float = 1.0):
        if n_chunks <= 0:
            raise ValueError(f"n_chunks should be positive, but got {n_chunks}")
        super().__init__(reduction)
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
            losses[key] = self._reduce(loss_t * weight_t.detach())
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
    scalar}`` (a bare scalar becomes ``{"loss": scalar}``)."""

    def __init__(self, loss_expr: Callable, weight=None):
        if weight is not None:
            raise NotImplementedError("FunctionalLoss's static weight is not ported yet")
        super().__init__("mean")
        self.loss_expr = loss_expr

    def __call__(self, output_dict, label_dict=None, weight_dict=None) -> Dict[str, torch.Tensor]:
        result = self.loss_expr(output_dict, label_dict, weight_dict)
        return result if isinstance(result, dict) else {"loss": result}
