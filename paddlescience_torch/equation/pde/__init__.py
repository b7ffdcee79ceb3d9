from paddlescience_torch.equation.pde.base import PDE
from paddlescience_torch.equation.pde.basic import AllenCahn, NavierStokes, NormalDotVec

__all__ = ["PDE", "AllenCahn", "NavierStokes", "NormalDotVec"]
