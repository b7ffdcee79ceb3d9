from paddlescience_torch.solver.solver import Solver

__all__ = ["Solver"]
