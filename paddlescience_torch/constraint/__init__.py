from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.constraint.constraints import SupervisedConstraint

__all__ = ["Constraint", "SupervisedConstraint"]
