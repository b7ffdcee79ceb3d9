from paddlescience_torch.equation.ide.volterra import Volterra

__all__ = ["Volterra"]
