import copy
from typing import Dict

from paddlescience_torch.equation.fpde import FractionalPoisson
from paddlescience_torch.equation.ide import Volterra
from paddlescience_torch.equation.pde import (NLSMB, PDE, AllenCahn, Biharmonic, HeatExchanger, Helmholtz, Hooke,
                                              Laplace, LinearElasticity, NavierStokes, NormalDotVec, Poisson,
                                              Vibration)

__all__ = ["PDE", "AllenCahn", "Biharmonic", "Helmholtz", "Laplace", "LinearElasticity", "NavierStokes",
           "NormalDotVec", "Poisson", "Vibration", "NLSMB", "HeatExchanger", "Hooke", "Volterra", "FractionalPoisson",
           "build_equation"]


def build_equation(cfg) -> Dict[str, PDE]:
    """Equations from config (the JAX package's ``build_equation``): a list
    of ``{"name": <class>, **kwargs}`` or a dict ``{<class>: kwargs}``;
    returns {class name: equation}."""
    cfg = copy.deepcopy(cfg)
    if isinstance(cfg, dict):
        cfg = [dict(name=k, **v) for k, v in cfg.items()]
    eq_dict = {}
    for item in cfg:
        item = dict(item)
        name = item.pop("name")
        cls = globals().get(name)
        if not (isinstance(cls, type) and issubclass(cls, PDE)):
            raise ValueError(f"unknown equation '{name}'")
        eq_dict[name] = cls(**item)
    return eq_dict
