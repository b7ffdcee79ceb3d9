from paddlescience_torch.equation.pde.base import PDE
from paddlescience_torch.equation.pde.basic import (AllenCahn, Biharmonic, Helmholtz, Laplace, LinearElasticity,
                                                    NavierStokes, NormalDotVec, Poisson, Vibration)
from paddlescience_torch.equation.pde.extra import NLSMB, HeatExchanger, Hooke

__all__ = ["PDE", "AllenCahn", "Biharmonic", "Helmholtz", "Laplace", "LinearElasticity", "NavierStokes",
           "NormalDotVec", "Poisson", "Vibration", "NLSMB", "HeatExchanger", "Hooke"]
