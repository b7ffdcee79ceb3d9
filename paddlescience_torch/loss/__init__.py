from paddlescience_torch.loss import mtl
from paddlescience_torch.loss.losses import CausalMSELoss, IntegralLoss, Loss, MSELoss

__all__ = ["mtl", "CausalMSELoss", "IntegralLoss", "Loss", "MSELoss"]
