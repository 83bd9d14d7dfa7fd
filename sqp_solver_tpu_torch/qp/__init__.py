from sqp_solver_tpu_torch.qp.admm import qp_solve
from sqp_solver_tpu_torch.qp.api import QPSolver
from sqp_solver_tpu_torch.qp.diff import qp_solve_diff
from sqp_solver_tpu_torch.qp.classify import (
    EQUALITY_CONSTRAINT,
    INEQUALITY_CONSTRAINT,
    LOOSE_BOUNDS,
    constr_type_init,
    rho_vec_from_type,
)
from sqp_solver_tpu_torch.qp.polish import (
    active_masks,
    guess_active_set,
    kkt_solve_schur_refined,
    polish_qp,
    reclassify_active_set,
)
from sqp_solver_tpu_torch.qp.scaling import Scaling, ruiz_equilibrate
from sqp_solver_tpu_torch.qp.sequence import qp_solve_sequence
from sqp_solver_tpu_torch.qp.types import (
    QPInfo,
    QPResult,
    QPSettings,
    QPState,
    QPStatus,
    QuadraticProblem,
)

__all__ = [
    "qp_solve",
    "qp_solve_diff",
    "QPSolver",
    "QuadraticProblem",
    "QPSettings",
    "QPStatus",
    "QPInfo",
    "QPState",
    "QPResult",
    "polish_qp",
    "kkt_solve_schur_refined",
    "reclassify_active_set",
    "qp_solve_sequence",
    "constr_type_init",
    "rho_vec_from_type",
    "ruiz_equilibrate",
    "Scaling",
    "active_masks",
    "guess_active_set",
    "INEQUALITY_CONSTRAINT",
    "EQUALITY_CONSTRAINT",
    "LOOSE_BOUNDS",
]
