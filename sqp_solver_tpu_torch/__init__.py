"""sqp_solver_tpu_torch — the PyTorch / CUDA port of ``sqp_solver_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  It holds the
reference-semantics tier, the per-problem ``qp_solve`` / ``sqp_solve``
with their class shims ``QPSolver`` / ``SQP`` and, as one batch-first
masked loop, ``qp_solve_batch`` / ``sqp_solve_batch`` at their default
``impl="vmap"``; the batched SQP solve, ``sqp_solve_batch(impl="fused")``
with ``SQPSettings(qp_impl="kernel")`` (the main path) or
``qp_impl="fused"``; the batched QP serving paths,
``qp_solve_batch(impl="kernel")`` and ``(impl="fused")`` with their
polish; Ruiz scaling (``scaling > 0``) on every QP tier and on the kernel
and fused SQP tiers; the sustained ``qp_solve_sequence`` /
``sqp_solve_sequence`` over any tier; and the structured tier for
stage-wise problems: ``qp_solve_batch(impl="kernel")`` with
``linear_solver="schur_block_tridiag"`` and ``sqp_solve_batch`` with
``qp_impl="kernel_btd"``; the linear-solver backends, ``schur_arrow``
with the coupled MPC family among them, and block-sparse operands on the
matrix-free ``cg``; the differentiable layers ``qp_solve_diff`` and
``sqp_solve_diff`` (``torch.autograd``); the batch split over devices
(``parallel.sharding``).  Its kernels (SQP step, polish KKT, whole QP
and SPD inverse in ``csrc/qp_kernel.cu``, the ADMM chunk in
``csrc/admm_kernel.cu``, the block-tridiagonal whole QP with its two
entry points in ``csrc/qp_kernel_btd.cu``) are hand-written CUDA for
sm_90a, each beside its plain PyTorch version.  Public functions are batch-first;
settings, statuses and field names are the JAX package's.  Generators
and constructors put their tensors on the card unless asked for another
device; solvers run on the device of their inputs.
"""

from sqp_solver_tpu_torch.parallel import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu_torch.qp import (
    QPInfo,
    QPResult,
    QPSettings,
    QPSolver,
    QPState,
    QPStatus,
    QuadraticProblem,
    qp_solve,
    qp_solve_sequence,
)
from sqp_solver_tpu_torch.sqp import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQP,
    SQPStatus,
    sqp_solve,
    sqp_solve_sequence,
)

__version__ = "0.1.0"

__all__ = [
    "qp_solve",
    "sqp_solve",
    "QPSolver",
    "SQP",
    "sqp_solve_batch",
    "qp_solve_batch",
    "qp_solve_sequence",
    "sqp_solve_sequence",
    "QuadraticProblem",
    "QPSettings",
    "QPState",
    "QPStatus",
    "QPInfo",
    "QPResult",
    "NonlinearProblem",
    "SQPSettings",
    "SQPStatus",
    "SQPInfo",
    "SQPResult",
    "__version__",
]
