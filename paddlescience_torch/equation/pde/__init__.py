from paddlescience_torch.equation.pde.base import PDE
from paddlescience_torch.equation.pde.basic import AllenCahn, Biharmonic, Laplace, NavierStokes, NormalDotVec

__all__ = ["PDE", "AllenCahn", "Biharmonic", "Laplace", "NavierStokes", "NormalDotVec"]
