"""Kernel-fused batch SQP solver (twin of ``sqp_solver_tpu/sqp/solver_kernel.py``).

Algorithm 18.3 with damped BFGS, posdef repair, l1 merit line search and
optional SOC (reference ``src/sqp.cpp:44-101``), around the SQP-step
kernel: each outer iteration's BFGS update, posdef fallback, Schur factor
and whole warm-started ADMM QP solve run as one kernel launch
(:func:`sqp_solver_tpu_torch.ops.qp_kernel.sqp_step_kernel`).  The outer
loop and the polish epilogue (one polish-KKT kernel launch per pass) are
:mod:`sqp_solver_tpu_torch.sqp.common`'s.  Only the user callables and
O(B (n + m)) vector arithmetic run as plain tensor ops.

Layout is batch-first throughout: the Hessian estimate is (B, n, n) and
the Jacobian (B, m, n).
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.ops.qp_kernel import sqp_step_kernel
from sqp_solver_tpu_torch.qp.types import QPState
from sqp_solver_tpu_torch.sqp import common
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["sqp_solve_kernel_fused"]


def _check_ported(settings: SQPSettings) -> None:
    """Reject inner-QP options whose code is not ported yet, naming the
    ROADMAP item that ports them, instead of routing elsewhere."""
    if settings.qp.scaling > 0:
        raise NotImplementedError(
            "qp.scaling > 0 (Ruiz equilibration) is not ported "
            "(ROADMAP Queue 1, item 'scaling')"
        )
    if settings.qp.acceleration == "anderson":
        raise NotImplementedError(
            "acceleration='anderson' is not ported (ROADMAP Queue 1, item 'Anderson')"
        )


@pin_precision
def sqp_solve_kernel_fused(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve a batch of NLPs through the SQP-step kernel; ``x0`` is (B, n).
    Same semantics as the JAX ``sqp_solve_kernel_fused``."""
    settings.validate()
    _check_ported(settings)
    soc = settings.second_order_correction

    def step(s: common.SubproblemInputs):
        # the BFGS update runs inside the kernel; reset and upd are masked
        # by `active`, so inactive problems pass their B through unchanged
        lqp, uqp = s.l - s.c_val, s.u - s.c_val
        out = sqp_step_kernel(
            s.B, s.J, s.grad_obj, lqp, uqp, s.step_prev, s.delta_grad_L,
            s.reset, s.upd, s.active, s.warm.x, s.warm.z, s.warm.y, settings.qp,
            do_bfgs=True, want_minv=soc,
        )
        p, lam_qp, qp_it = out.p, out.y, out.iter
        state = QPState(x=p, z=out.z, y=lam_qp)
        if soc:
            # factor reuse: only l, u change between the QP and its SOC
            # re-solve, so Minv and its rho carry over
            d = s.c_of(s.x + p) - torch.matmul(s.J, p.unsqueeze(-1)).squeeze(-1)
            warm = state if settings.qp_warm_start else s.warm
            out2 = sqp_step_kernel(
                out.B, s.J, s.grad_obj, s.l - d, s.u - d, s.step_prev, s.delta_grad_L,
                s.reset, s.upd, s.active, warm.x, warm.z, warm.y, settings.qp,
                do_bfgs=False, rho_in=out.rho_factor, minv_in=out.minv,
            )
            p, lam_qp, qp_it = out2.p, out2.y, qp_it + out2.iter
            state = QPState(x=p, z=out2.z, y=lam_qp)
        return p, lam_qp, out.B, state, qp_it

    return common.sqp_outer_loop(problem, x0, lam0, settings, step)
