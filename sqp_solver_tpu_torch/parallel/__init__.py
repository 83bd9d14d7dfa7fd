from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch

__all__ = ["qp_solve_batch", "sqp_solve_batch"]
