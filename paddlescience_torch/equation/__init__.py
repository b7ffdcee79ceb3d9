from paddlescience_torch.equation.pde import PDE, AllenCahn

__all__ = ["PDE", "AllenCahn"]
