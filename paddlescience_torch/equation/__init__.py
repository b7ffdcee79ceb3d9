from paddlescience_torch.equation.pde import PDE, AllenCahn, Biharmonic, Laplace, NavierStokes, NormalDotVec

__all__ = ["PDE", "AllenCahn", "Biharmonic", "Laplace", "NavierStokes", "NormalDotVec"]
