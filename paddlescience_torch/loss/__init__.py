import copy

from paddlescience_torch.loss import mtl
from paddlescience_torch.loss.losses import CausalMSELoss, FunctionalLoss, IntegralLoss, L2RelLoss, Loss, MSELoss

__all__ = ["mtl", "CausalMSELoss", "FunctionalLoss", "IntegralLoss", "L2RelLoss", "Loss", "MSELoss", "build_loss"]


def build_loss(cfg):
    """A loss from ``{"name": <class>, **kwargs}``."""
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name")
    cls = globals().get(name)
    if not (isinstance(cls, type) and issubclass(cls, Loss)):
        raise ValueError(f"unknown loss '{name}'")
    return cls(**cfg)
