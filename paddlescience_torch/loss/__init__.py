from paddlescience_torch.loss import mtl
from paddlescience_torch.loss.losses import CausalMSELoss, Loss, MSELoss

__all__ = ["mtl", "CausalMSELoss", "Loss", "MSELoss"]
