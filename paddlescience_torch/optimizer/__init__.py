from paddlescience_torch.optimizer import lr_scheduler
from paddlescience_torch.optimizer.optimizer import Adam, Optimizer

__all__ = ["lr_scheduler", "Adam", "Optimizer"]
