import copy

from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.constraint.constraints import (BoundaryConstraint, InitialConstraint, IntegralConstraint,
                                                        InteriorConstraint, PeriodicConstraint, SupervisedConstraint)

__all__ = ["Constraint", "BoundaryConstraint", "InitialConstraint", "IntegralConstraint", "InteriorConstraint",
           "PeriodicConstraint", "SupervisedConstraint", "build_constraint"]


def build_constraint(cfg, equation_dict=None, geom_dict=None):
    """Constraints from a config (the JAX package's ``build_constraint``):
    ``cfg`` holds a shared ``dataloader`` block and a ``content`` list of
    ``{ClassName: kwargs}`` items; each item's own ``dataloader`` is
    updated with the shared one (the shared keys win, as in JAX), an
    ``output_expr`` string resolves to that equation's ``.equations``, a
    ``geom`` string through ``geom_dict``, and a ``loss`` config through
    ``loss.build_loss``. Returns {name: constraint}; None for no config."""
    from paddlescience_torch.loss import build_loss

    if cfg is None:
        return None
    cfg = copy.deepcopy(dict(cfg))
    shared = dict(cfg.get("dataloader", {}))
    out = {}
    for item in cfg["content"]:
        cls_name = next(iter(item))
        kwargs = dict(item[cls_name])
        name = kwargs.get("name", cls_name)
        if isinstance(kwargs.get("output_expr"), str):
            kwargs["output_expr"] = equation_dict[kwargs.pop("output_expr")].equations
        if isinstance(kwargs.get("geom"), str):
            kwargs["geom"] = geom_dict[kwargs.pop("geom")]
        dl = dict(kwargs.pop("dataloader", {}))
        dl.update(shared)
        kwargs["dataloader_cfg"] = dl
        if "loss" in kwargs and not callable(kwargs["loss"]):
            kwargs["loss"] = build_loss(kwargs["loss"])
        out[name] = globals()[cls_name](**kwargs)
    return out
