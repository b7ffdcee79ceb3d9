from paddlescience_torch.autodiff import jet, path
from paddlescience_torch.autodiff.ad import jacobian

__all__ = ["jet", "path", "jacobian"]
