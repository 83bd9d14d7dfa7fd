from sqp_solver_tpu_torch.sqp.sequence import sqp_solve_sequence
from sqp_solver_tpu_torch.sqp.types import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQPStatus,
)

__all__ = [
    "NonlinearProblem",
    "SQPSettings",
    "SQPStatus",
    "SQPInfo",
    "SQPResult",
    "sqp_solve_sequence",
]
