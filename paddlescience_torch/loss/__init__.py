import copy

from paddlescience_torch.loss import mtl
from paddlescience_torch.loss.base import Loss
from paddlescience_torch.loss.losses import (CausalMSELoss, ChamferLoss, FunctionalLoss, IntegralLoss, KLLoss, L1Loss,
                                             L2Loss, L2RelLoss, MAELoss, MSELoss, MSELossWithL2Decay, PeriodicL1Loss,
                                             PeriodicL2Loss)

__all__ = ["mtl", "Loss", "MSELoss", "CausalMSELoss", "MSELossWithL2Decay", "L1Loss", "PeriodicL1Loss", "L2Loss",
           "PeriodicL2Loss", "L2RelLoss", "MAELoss", "KLLoss", "ChamferLoss", "IntegralLoss", "FunctionalLoss",
           "build_loss"]


def build_loss(cfg):
    """A loss from ``{"name": <class>, **kwargs}`` (any class above)."""
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name")
    cls = globals().get(name)
    if not (isinstance(cls, type) and issubclass(cls, Loss)):
        raise ValueError(f"unknown loss '{name}'")
    return cls(**cfg)
