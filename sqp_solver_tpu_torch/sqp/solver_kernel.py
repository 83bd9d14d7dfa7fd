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
from sqp_solver_tpu_torch.qp.scaling import scale_state
from sqp_solver_tpu_torch.qp.types import QPState, QuadraticProblem
from sqp_solver_tpu_torch.sqp import common
from sqp_solver_tpu_torch.sqp.bfgs import bfgs_update
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["sqp_solve_kernel_fused"]


def _scaled_operands(Bm, s: common.SubproblemInputs, lqp, uqp, warm: QPState, iters: int,
                     scale=None):
    """The subproblem's kernel operands in Ruiz-scaled coordinates, and the
    :class:`~sqp_solver_tpu_torch.qp.scaling.Scaling`.  ``scale`` (a
    first solve's factors) rescales instead of equilibrating afresh, so a
    re-solve that reuses that solve's Minv iterates the operator it was
    factored for."""
    from sqp_solver_tpu_torch.qp.scaling import ruiz_equilibrate

    if scale is None:
        qp, scale = ruiz_equilibrate(QuadraticProblem(P=Bm, q=s.grad_obj, A=s.J, l=lqp, u=uqp),
                                     iters)
        P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    else:
        d, e, c = scale.d, scale.e, scale.c
        P = c[:, None, None] * d.unsqueeze(-1) * Bm * d.unsqueeze(-2)
        q = c.unsqueeze(-1) * d * s.grad_obj
        A = e.unsqueeze(-1) * s.J * d.unsqueeze(-2)
        l, u = lqp * e, uqp * e
    st = scale_state(warm, scale)
    return (P.contiguous(), A.contiguous(), q.contiguous(), l.contiguous(), u.contiguous(),
            st, scale)


@pin_precision
def sqp_solve_kernel_fused(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve a batch of NLPs through the SQP-step kernel; ``x0`` is (B, n).
    Same semantics as the JAX ``sqp_solve_kernel_fused``.

    With ``qp.scaling > 0`` each subproblem is Ruiz-equilibrated before its
    launch: the damped BFGS then runs outside the kernel
    (:func:`sqp_solver_tpu_torch.sqp.bfgs.bfgs_update`, since the kernel's
    update would see the scaled Hessian against unscaled s and y), K1 runs
    with ``do_bfgs=False``, its result is unscaled, and the unscaled
    Hessian is what the outer loop carries."""
    settings.validate()
    soc = settings.second_order_correction
    iters = settings.qp.scaling

    def launch(Bm, s, lqp, uqp, warm, do_bfgs, **kw):
        return sqp_step_kernel(
            Bm, s.J, s.grad_obj, lqp, uqp, s.step_prev, s.delta_grad_L,
            s.reset, s.upd, s.active, warm.x, warm.z, warm.y, settings.qp,
            do_bfgs=do_bfgs, **kw)

    def scaled_launch(Bm, s, lqp, uqp, warm, scale=None, **kw):
        P, A, q, l, u, st, scale = _scaled_operands(Bm, s, lqp, uqp, warm, iters, scale)
        out = sqp_step_kernel(
            P, A, q, l, u, s.step_prev, s.delta_grad_L, s.reset, s.upd, s.active,
            st.x, st.z, st.y, settings.qp, do_bfgs=False, **kw)
        d, e, c = scale.d, scale.e, scale.c
        # the unscaled iterates; B stays the caller's
        return out._replace(p=out.p * d, z=out.z / e, y=out.y * e / c.unsqueeze(-1),
                            B=Bm), scale

    def step(s: common.SubproblemInputs):
        lqp, uqp = s.l - s.c_val, s.u - s.c_val
        if iters > 0:
            Bm = bfgs_update(s.B, s.step_prev, s.delta_grad_L, s.reset, s.upd)
            out, scale = scaled_launch(Bm, s, lqp, uqp, s.warm, want_minv=soc)
        else:
            # the BFGS update runs inside the kernel; reset and upd are
            # masked by `active`, so inactive problems pass their B through
            out = launch(s.B, s, lqp, uqp, s.warm, True, want_minv=soc)
        p, lam_qp, qp_it = out.p, out.y, out.iter
        state = QPState(x=p, z=out.z, y=lam_qp)
        if soc:
            # factor reuse: only l, u change between the QP and its SOC
            # re-solve, so Minv and its rho carry over (under scaling with
            # the first solve's factors, so Minv matches the scaled operator)
            d = s.c_of(s.x + p) - torch.matmul(s.J, p.unsqueeze(-1)).squeeze(-1)
            warm = state if settings.qp_warm_start else s.warm
            kw = dict(rho_in=out.rho_factor, minv_in=out.minv)
            if iters > 0:
                out2, _ = scaled_launch(out.B, s, s.l - d, s.u - d, warm, scale, **kw)
            else:
                out2 = launch(out.B, s, s.l - d, s.u - d, warm, False, **kw)
            p, lam_qp, qp_it = out2.p, out2.y, qp_it + out2.iter
            state = QPState(x=p, z=out2.z, y=lam_qp)
        return p, lam_qp, out.B, state, qp_it

    return common.sqp_outer_loop(problem, x0, lam0, settings, step)
