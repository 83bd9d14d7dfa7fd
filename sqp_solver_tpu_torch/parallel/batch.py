"""Batched solves (twin of ``sqp_solver_tpu/parallel/batch.py``).

Only ``sqp_solve_batch(impl="fused")`` is ported.  The per-problem
``impl="vmap"`` tier and ``qp_solve_batch`` raise ``NotImplementedError``
naming their ROADMAP items.
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = ["sqp_solve_batch"]


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
