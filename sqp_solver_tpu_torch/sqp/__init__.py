from sqp_solver_tpu_torch.sqp.api import SQP
from sqp_solver_tpu_torch.sqp.bfgs import bfgs_update
from sqp_solver_tpu_torch.sqp.diff import sqp_solve_diff
from sqp_solver_tpu_torch.sqp.sequence import sqp_solve_sequence
from sqp_solver_tpu_torch.sqp.solver import sqp_solve
from sqp_solver_tpu_torch.sqp.types import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQPStatus,
)

__all__ = [
    "sqp_solve",
    "sqp_solve_diff",
    "SQP",
    "bfgs_update",
    "NonlinearProblem",
    "SQPSettings",
    "SQPStatus",
    "SQPInfo",
    "SQPResult",
    "sqp_solve_sequence",
]
