from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch

__all__ = ["sqp_solve_batch"]
