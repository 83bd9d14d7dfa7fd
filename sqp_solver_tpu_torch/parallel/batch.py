"""Batched solves (twin of ``sqp_solver_tpu/parallel/batch.py``).

Ported: ``qp_solve_batch(impl="fused")`` over the ADMM chunk kernel K5,
``qp_solve_batch(impl="kernel")`` over the whole-QP kernel and
``sqp_solve_batch(impl="fused")``.  The per-problem ``impl="vmap"`` tiers
(the JAX default) and Ruiz scaling raise ``NotImplementedError`` naming
their ROADMAP items.
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.qp.types import QPResult, QPSettings, QPState, QuadraticProblem
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = ["qp_solve_batch", "sqp_solve_batch"]


def qp_solve_batch(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    state: Optional[QPState] = None,
    impl: str = "vmap",
) -> QPResult:
    """Solve a batch of QPs (leading batch axis on every problem field).
    ``impl="fused"`` is the fused ADMM tier (chunks of ``check_termination``
    iterations, one K5 launch each), ``impl="kernel"`` the whole-QP
    kernel; the default ``"vmap"`` is the JAX package's semantics-defining
    tier, which this package does not have yet."""
    if settings.scaling > 0:
        raise NotImplementedError(
            "scaling > 0 (Ruiz equilibration) is not ported "
            "(ROADMAP Queue 1, item 'scaling')"
        )
    if impl == "kernel":
        from sqp_solver_tpu_torch.ops.qp_kernel import qp_solve_kernel

        return qp_solve_kernel(qp, settings, state)
    if impl == "fused":
        from sqp_solver_tpu_torch.qp.admm_batched import qp_solve_fused

        return qp_solve_fused(qp, settings, state)
    raise NotImplementedError(
        f"qp_solve_batch(impl={impl!r}) is not ported; use impl='fused' or 'kernel' "
        "(ROADMAP Queue 1, item 9 'qp/admm.py')"
    )


def sqp_solve_batch(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
    impl: str = "vmap",
) -> SQPResult:
    """Solve a batch of NLPs; ``x0`` is (B, n), ``problem.l``/``u`` are
    (B, m) or shared (m,).  ``impl="fused"`` is the production path; the
    default ``"vmap"`` is the JAX package's semantics-defining tier, which
    this package does not have yet."""
    if impl != "fused":
        raise NotImplementedError(
            f"sqp_solve_batch(impl={impl!r}) is not ported; use impl='fused' "
            "(ROADMAP Queue 1, item 'impl=\"vmap\"')"
        )
    from sqp_solver_tpu_torch.sqp.solver_batched import sqp_solve_fused

    return sqp_solve_fused(problem, x0, lam0, settings)
