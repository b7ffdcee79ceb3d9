from paddlescience_torch.equation.pde import PDE, AllenCahn, NavierStokes, NormalDotVec

__all__ = ["PDE", "AllenCahn", "NavierStokes", "NormalDotVec"]
