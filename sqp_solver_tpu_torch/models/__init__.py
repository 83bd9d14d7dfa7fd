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
    mpc_qp_coupled_batch,
    mpc_qp_stagewise_batch,
    random_qp_batch,
)
from sqp_solver_tpu_torch.models.problems import (
    constrained_rosenbrock_2d,
    rosenbrock_box,
    simple_nlp,
    simple_nlp2,
    simple_qp,
    simple_qp_nlp,
)
from sqp_solver_tpu_torch.models.sparse import sparse_qp_pair

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
    "mpc_qp_coupled_batch",
    "sparse_qp_pair",
    "simple_qp",
    "simple_nlp",
    "simple_qp_nlp",
    "constrained_rosenbrock_2d",
    "rosenbrock_box",
    "simple_nlp2",
]
