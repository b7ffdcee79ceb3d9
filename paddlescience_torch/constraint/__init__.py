from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.constraint.constraints import (BoundaryConstraint, IntegralConstraint, InteriorConstraint,
                                                        SupervisedConstraint)

__all__ = ["Constraint", "BoundaryConstraint", "IntegralConstraint", "InteriorConstraint", "SupervisedConstraint"]
