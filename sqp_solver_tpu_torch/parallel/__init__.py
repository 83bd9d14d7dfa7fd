from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_batch,
    sharded_qp_solve_batch,
    sharded_sqp_solve_batch,
)

__all__ = [
    "qp_solve_batch",
    "sqp_solve_batch",
    "make_mesh",
    "shard_batch",
    "sharded_qp_solve_batch",
    "sharded_sqp_solve_batch",
]
