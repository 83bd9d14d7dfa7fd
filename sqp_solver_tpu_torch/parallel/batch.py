"""Batched solves (twin of ``sqp_solver_tpu/parallel/batch.py``).

``impl="vmap"``, the default of both entries, is the per-problem
reference-semantics tier (:mod:`sqp_solver_tpu_torch.qp.admm`,
:mod:`sqp_solver_tpu_torch.sqp.solver`) run as one batch-first masked
loop; ``qp_solve_batch(impl="fused")`` is the fused ADMM tier over the
chunk kernel K5, ``(impl="kernel")`` the whole-QP kernel, and
``sqp_solve_batch(impl="fused")`` the batch-explicit SQP tiers.  With
``settings.scaling > 0`` every QP tier runs inside the Ruiz scaling
pipeline (:func:`sqp_solver_tpu_torch.qp.scaling.solve_with_scaling`).
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
    ``impl="vmap"`` is the semantics-defining tier, ``"fused"`` the fused
    ADMM tier (chunks of ``check_termination`` iterations, one K5 launch
    each), ``"kernel"`` the whole-QP kernel."""
    if impl not in ("vmap", "fused", "kernel"):
        raise ValueError(f"impl must be 'vmap', 'fused' or 'kernel', got {impl!r}")
    if settings.scaling > 0:
        # equilibrate per problem, solve scaled through whichever tier, then
        # rescore against the original problem (qp/scaling.py)
        from sqp_solver_tpu_torch.qp.scaling import solve_with_scaling

        return solve_with_scaling(
            lambda p, s_, st_: qp_solve_batch(p, s_, st_, impl=impl), qp, settings, state)
    if impl == "kernel":
        from sqp_solver_tpu_torch.ops.qp_kernel import qp_solve_kernel

        return qp_solve_kernel(qp, settings, state)
    if impl == "fused":
        from sqp_solver_tpu_torch.qp.admm_batched import qp_solve_fused

        return qp_solve_fused(qp, settings, state)
    from sqp_solver_tpu_torch.qp.admm import qp_solve_masked

    return qp_solve_masked(qp, settings, state)


def sqp_solve_batch(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
    impl: str = "vmap",
) -> SQPResult:
    """Solve a batch of NLPs; ``x0`` is (B, n).  The problem's ``l``/``u``
    are batched (B, m) when ``l.ndim == x0.ndim``, else shared (m,).
    ``impl="vmap"`` is the semantics-defining tier, ``"fused"`` the
    production path (``settings.qp_impl`` picks its QP tier)."""
    if impl == "fused":
        from sqp_solver_tpu_torch.sqp.solver_batched import sqp_solve_fused

        return sqp_solve_fused(problem, x0, lam0, settings)
    if impl != "vmap":
        raise ValueError(f"impl must be 'vmap' or 'fused', got {impl!r}")
    from sqp_solver_tpu_torch.sqp.solver import sqp_solve

    return sqp_solve(problem, x0, lam0, settings)
