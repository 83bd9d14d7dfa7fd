"""Batch-explicit SQP entry and the fused SQP tier (twin of
``sqp_solver_tpu/sqp/solver_batched.py``).

``qp_impl="kernel"`` hands over to the SQP-step kernel tier
(:mod:`sqp_solver_tpu_torch.sqp.solver_kernel`).  ``qp_impl="fused"``, the
default, runs Algorithm 18.3 (reference ``src/sqp.cpp:44-101``) through
the shared outer loop :func:`sqp_solver_tpu_torch.sqp.common.sqp_outer_loop`
with its own subproblem step: damped BFGS, posdef repair, and the QP
subproblem (and optional SOC) through the fused ADMM tier
(:func:`sqp_solver_tpu_torch.qp.admm_batched.qp_solve_fused`, chunks of
the K5 kernel), warm-started across outer iterations.  ``qp_impl="kernel_btd"``
hands over to the structured tier over the block-tridiagonal step kernel
(:mod:`sqp_solver_tpu_torch.sqp.solver_btd`).  With ``qp.scaling > 0``
each subproblem, the SOC re-solve included, is equilibrated afresh
(:func:`sqp_solver_tpu_torch.qp.scaling.solve_with_scaling`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sqp_solver_tpu_torch.sqp.bfgs import bfgs_update
from sqp_solver_tpu_torch.qp.types import QuadraticProblem
from sqp_solver_tpu_torch.sqp import common
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["sqp_solve_fused"]


def sqp_solve_fused(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve a batch of NLPs: ``x0`` is (B, n)."""
    settings.validate()
    if settings.qp_impl == "kernel":
        from sqp_solver_tpu_torch.sqp.solver_kernel import sqp_solve_kernel_fused

        return sqp_solve_kernel_fused(problem, x0, lam0, settings)
    if settings.qp_impl == "kernel_btd":
        from sqp_solver_tpu_torch.sqp.solver_btd import sqp_solve_kernel_btd

        return sqp_solve_kernel_btd(problem, x0, lam0, settings)
    if settings.qp.linear_solver != "schur_cholesky":
        raise ValueError("sqp_solve_fused requires qp.linear_solver='schur_cholesky'")
    return _sqp_solve_qp_fused(problem, x0, lam0, settings)


@pin_precision
def _sqp_solve_qp_fused(problem, x0, lam0, settings: SQPSettings) -> SQPResult:
    from sqp_solver_tpu_torch.qp.admm_batched import qp_solve_fused

    eye = torch.eye(x0.shape[-1], dtype=x0.dtype, device=x0.device)

    def posdef_repair(Bm):
        if settings.schedule != "fixed":
            return common.posdef_repair(Bm)
        # one check, reset to the identity where it fails
        Bm = torch.where(torch.isnan(Bm).flatten(1).any(-1)[:, None, None], eye, Bm)
        return torch.where(common.not_posdef(Bm)[:, None, None], eye, Bm)

    # subproblem infeasibility certificates are off on every SQP tier: a
    # transiently certified linearized subproblem must not stop early
    inner = dataclasses.replace(settings.qp, check_infeasibility=False)

    def solve_subproblem(qp, warm):
        if inner.scaling > 0:
            # per-problem Ruiz equilibration of every subproblem: solved
            # scaled, unscaled and rescored against the true subproblem
            from sqp_solver_tpu_torch.qp.scaling import solve_with_scaling

            return solve_with_scaling(qp_solve_fused, qp, inner, warm)
        return qp_solve_fused(qp, inner, warm)

    def step(s):
        B_new = posdef_repair(bfgs_update(s.B, s.step_prev, s.delta_grad_L, s.reset, s.upd))
        res = solve_subproblem(QuadraticProblem(P=B_new, q=s.grad_obj, A=s.J, l=s.l - s.c_val,
                                                u=s.u - s.c_val), s.warm)
        qp_it = res.info.iter
        if settings.second_order_correction:
            d = s.c_of(s.x + res.x) - torch.matmul(s.J, res.x.unsqueeze(-1)).squeeze(-1)
            warm = res.state if settings.qp_warm_start else s.warm
            res = solve_subproblem(QuadraticProblem(P=B_new, q=s.grad_obj, A=s.J, l=s.l - d,
                                                    u=s.u - d), warm)
            qp_it = qp_it + res.info.iter
        B_new = torch.where(s.active[:, None, None], B_new, s.B)
        return res.x, res.y, B_new, res.state, qp_it

    return common.sqp_outer_loop(problem, x0, lam0, settings, step)
