from sqp_solver_tpu_torch.models import families, problems
from sqp_solver_tpu_torch.models.benchmark import (
    sphere_cap_nlp_batch,
    sphere_cap_problem,
    sphere_cap_solution,
)
from sqp_solver_tpu_torch.models.mpc import (
    mpc_nlp_kkt_residuals,
    mpc_nlp_stagewise_batch,
    mpc_qp_batch,
    mpc_qp_stagewise_batch,
    random_qp_batch,
)

__all__ = [
    "families",
    "problems",
    "sphere_cap_nlp_batch",
    "sphere_cap_problem",
    "sphere_cap_solution",
    "mpc_qp_batch",
    "random_qp_batch",
    "mpc_qp_stagewise_batch",
    "mpc_nlp_stagewise_batch",
    "mpc_nlp_kkt_residuals",
]
