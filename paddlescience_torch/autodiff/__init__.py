from paddlescience_torch.autodiff import jet, path
from paddlescience_torch.autodiff.ad import Tape, clear, current_tape, hessian, hessian_fn, jacobian, jacobian_fn

__all__ = ["jet", "path", "Tape", "clear", "current_tape", "hessian", "hessian_fn", "jacobian", "jacobian_fn"]
