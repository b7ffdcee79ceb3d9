from paddlescience_torch.optimizer import lr_scheduler
from paddlescience_torch.optimizer.optimizer import LBFGS, Adam, AdamW, Optimizer

__all__ = ["lr_scheduler", "Adam", "AdamW", "LBFGS", "Optimizer"]
