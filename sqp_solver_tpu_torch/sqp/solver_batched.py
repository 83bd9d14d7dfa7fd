"""Batch-explicit SQP entry (twin of ``sqp_solver_tpu/sqp/solver_batched.py``).

Only the ``qp_impl="kernel"`` dispatch is ported: the fused QP tier
(``qp_impl="fused"``) and the structured tier (``"kernel_btd"``) raise
``NotImplementedError`` naming their ROADMAP items.
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = ["sqp_solve_fused"]


def sqp_solve_fused(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve a batch of NLPs: ``x0`` is (B, n)."""
    settings.validate()
    if settings.qp_impl != "kernel":
        raise NotImplementedError(
            f"qp_impl={settings.qp_impl!r} is not ported; only 'kernel' is "
            "(ROADMAP Queue 1, items 'fused QP tier' and 'structured tier')"
        )
    from sqp_solver_tpu_torch.sqp.solver_kernel import sqp_solve_kernel_fused

    return sqp_solve_kernel_fused(problem, x0, lam0, settings)
