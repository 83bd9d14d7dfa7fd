from sqp_solver_tpu_torch.qp.classify import (
    EQUALITY_CONSTRAINT,
    INEQUALITY_CONSTRAINT,
    LOOSE_BOUNDS,
    constr_type_init,
)
from sqp_solver_tpu_torch.qp.polish import active_masks, guess_active_set
from sqp_solver_tpu_torch.qp.types import QPSettings, QPState, QPStatus

__all__ = [
    "QPSettings",
    "QPStatus",
    "QPState",
    "constr_type_init",
    "active_masks",
    "guess_active_set",
    "INEQUALITY_CONSTRAINT",
    "EQUALITY_CONSTRAINT",
    "LOOSE_BOUNDS",
]
