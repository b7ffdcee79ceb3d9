from paddlescience_torch.equation.fpde import FractionalPoisson
from paddlescience_torch.equation.ide import Volterra
from paddlescience_torch.equation.pde import (NLSMB, PDE, AllenCahn, Biharmonic, HeatExchanger, Helmholtz, Hooke,
                                              Laplace, LinearElasticity, NavierStokes, NormalDotVec, Poisson,
                                              Vibration)

__all__ = ["PDE", "AllenCahn", "Biharmonic", "Helmholtz", "Laplace", "LinearElasticity", "NavierStokes",
           "NormalDotVec", "Poisson", "Vibration", "NLSMB", "HeatExchanger", "Hooke", "Volterra", "FractionalPoisson"]
