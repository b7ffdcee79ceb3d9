from paddlescience_torch.equation.fpde.fractional_poisson import FractionalPoisson

__all__ = ["FractionalPoisson"]
