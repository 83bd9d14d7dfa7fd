"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version,
and the linear-solver backends of the ADMM tiers."""

from sqp_solver_tpu_torch.ops.linear_solver import get_linear_solver, ldlt_factor, ldlt_solve

__all__ = ["get_linear_solver", "ldlt_factor", "ldlt_solve"]
