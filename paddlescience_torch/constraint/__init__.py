from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.constraint.constraints import (BoundaryConstraint, InitialConstraint, IntegralConstraint,
                                                        InteriorConstraint, SupervisedConstraint)

__all__ = ["Constraint", "BoundaryConstraint", "InitialConstraint", "IntegralConstraint", "InteriorConstraint",
           "SupervisedConstraint"]
