import copy

from paddlescience_torch.optimizer import lr_scheduler
from paddlescience_torch.optimizer.optimizer import (LBFGS, SGD, Adam, AdamW, Momentum, Optimizer, OptimizerList,
                                                     RMSProp)

__all__ = ["lr_scheduler", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "RMSProp", "LBFGS", "OptimizerList",
           "build_optimizer", "build_lr_scheduler"]


def build_lr_scheduler(cfg, epochs: int, iters_per_epoch: int):
    """A schedule from ``{"name": <class>, **kwargs}``; ``epochs`` and
    ``iters_per_epoch`` fill in where the config leaves them out."""
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name", "Constant")
    cfg.setdefault("epochs", epochs)
    cfg.setdefault("iters_per_epoch", iters_per_epoch)
    cls = getattr(lr_scheduler, name, None)
    if cls is None:
        raise ValueError(f"unknown lr scheduler '{name}'")
    if name == "Constant":
        cfg = {"learning_rate": cfg["learning_rate"]}
    return cls(**cfg)()


def build_optimizer(cfg, model, epochs: int, iters_per_epoch: int):
    """An optimizer of ``model`` from ``{"name": <class>, "lr_scheduler":
    {...}, **kwargs}``."""
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name", "Adam")
    lr_cfg = cfg.pop("lr_scheduler", None)
    if lr_cfg is not None:
        cfg["learning_rate"] = build_lr_scheduler(lr_cfg, epochs, iters_per_epoch)
    factory = globals().get(name)
    if factory is None or name in ("Optimizer", "OptimizerList"):
        raise ValueError(f"unknown optimizer '{name}'")
    return factory(**cfg)(model)
