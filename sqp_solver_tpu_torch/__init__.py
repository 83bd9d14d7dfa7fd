"""sqp_solver_tpu_torch — the PyTorch / CUDA port of ``sqp_solver_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  It holds the
batched SQP main path: ``parallel.sqp_solve_batch(impl="fused")`` with
``SQPSettings(qp_impl="kernel")``, whose two kernels (the SQP-step kernel
and the polish-KKT kernel) are hand-written CUDA for sm_90a in
``csrc/qp_kernel.cu``, each beside its plain PyTorch version.  Public
functions are batch-first; settings, statuses and field names are the JAX
package's.  Parts outside this slice raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from sqp_solver_tpu_torch.parallel import sqp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings, QPState, QPStatus
from sqp_solver_tpu_torch.sqp import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQPStatus,
)

__version__ = "0.1.0"

__all__ = [
    "sqp_solve_batch",
    "QPSettings",
    "QPState",
    "QPStatus",
    "NonlinearProblem",
    "SQPSettings",
    "SQPStatus",
    "SQPInfo",
    "SQPResult",
    "__version__",
]
