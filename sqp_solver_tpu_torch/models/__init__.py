from sqp_solver_tpu_torch.models.benchmark import (
    sphere_cap_nlp_batch,
    sphere_cap_problem,
    sphere_cap_solution,
)

__all__ = ["sphere_cap_nlp_batch", "sphere_cap_problem", "sphere_cap_solution"]
