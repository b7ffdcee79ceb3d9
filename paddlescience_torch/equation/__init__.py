from paddlescience_torch.equation.pde import PDE, AllenCahn, Biharmonic, NavierStokes, NormalDotVec

__all__ = ["PDE", "AllenCahn", "Biharmonic", "NavierStokes", "NormalDotVec"]
