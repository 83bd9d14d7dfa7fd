"""Differentiable QP layer (twin of ``sqp_solver_tpu/qp/diff.py``).

``qp_solve_diff(qp, settings, impl)`` returns the primal solution x*, and
``torch.autograd`` differentiates it with respect to every problem tensor
(P, q, A, l, u) by implicit differentiation of the KKT conditions at the
converged active set (the OptNet scheme, Amos & Kolter 2017).

With the active rows A~ and their multipliers nu, the KKT system is
P x + q + A~' nu = 0, A~ x = b~.  For a loss with cotangent g = dl/dx*,
the adjoint (dz_x, dz_nu) solves the same symmetric system with the
right-hand side (-g, 0):

    P dz_x + A~' dz_nu = -g,      A~ dz_x = 0,

and the gradients are outer products:

    dl/dP = (dz_x x*' + x* dz_x') / 2,   dl/dq = dz_x,
    dl/dA = nu dz_x' + dz_nu x*'  (active rows; 0 on the others),
    dl/db~ = -dz_nu, to l on rows active at their lower bound, to u at
    their upper bound, split 50/50 on equality rows.

The adjoint solve is the polish KKT solve
:func:`~sqp_solver_tpu_torch.qp.polish.kkt_solve_schur_refined`, which on
CUDA tensors runs the polish-KKT kernel (K2), or the SPD-inverse kernel
(K4) with ``use_kernel=False``.  Problems whose adjoint factor fails or
whose forward solve did not reach SOLVED get zero gradients.  The
gradient is exact under strict complementarity and LICQ at x*; solve
tightly and with ``polish=True``, since a loose dual can flip the active
set.
"""

from __future__ import annotations

import torch

from sqp_solver_tpu_torch.qp.polish import active_masks, kkt_solve_schur_refined
from sqp_solver_tpu_torch.qp.types import QPSettings, QuadraticProblem
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["qp_solve_diff", "qp_solve_vjp"]


def _outer(a, b):
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def _solve(qp: QuadraticProblem, settings: QPSettings, impl: str):
    if qp.q.dim() == 1:
        from sqp_solver_tpu_torch.qp.admm import qp_solve

        return qp_solve(qp, settings)
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    return qp_solve_batch(qp, settings, impl=impl)


@pin_precision
def qp_solve_vjp(P, A, l, u, x, y, status, g, settings: QPSettings = QPSettings(),
                 use_kernel=None):
    """The backward pass of :func:`qp_solve_diff`: the gradients
    ``(dP, dq, dA, dl, du)`` of a loss with cotangent ``g`` with respect to
    the problem, at the solution (x, y) and forward ``status``.
    ``use_kernel`` picks the adjoint solve's route, as in
    :func:`~sqp_solver_tpu_torch.qp.polish.kkt_solve_schur_refined`."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    eq, act_low, act_up = active_masks(l, u, y)
    act = eq | act_low | act_up
    A_m = torch.where(act.unsqueeze(-1), A, zero)
    nu = torch.where(act, y, zero)
    dz_x, dz_nu, fail = kkt_solve_schur_refined(
        P, A_m, act, -g, torch.zeros_like(l), delta=settings.polish_delta,
        sweeps=settings.polish_sweeps, use_kernel=use_kernel)
    # a failed adjoint factor, or a forward solve that did not reach SOLVED
    # (the premise "y is the converged dual" is false), gives zero gradients
    ok = (~fail & (status == 0)).unsqueeze(-1)
    dz_x = torch.where(ok, dz_x, zero)
    dz_nu = torch.where(ok, dz_nu, zero)
    dP = 0.5 * (_outer(dz_x, x) + _outer(x, dz_x))
    dA = torch.where(act.unsqueeze(-1), _outer(nu, dz_x) + _outer(dz_nu, x), zero)
    db = -dz_nu
    half = torch.where(eq, 0.5 * db, zero)
    dl = torch.where(act_low, db, zero) + half
    du = torch.where(act_up, db, zero) + half
    return dP, dz_x, dA, dl, du


class _QPSolveDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, P, q, A, l, u, settings, impl):
        with torch.no_grad():
            res = _solve(QuadraticProblem(P=P, q=q, A=A, l=l, u=u), settings, impl)
        ctx.settings = settings
        ctx.save_for_backward(P, A, l, u, res.x, res.y, res.info.status)
        return res.x

    @staticmethod
    def backward(ctx, g):
        P, A, l, u, x, y, status = ctx.saved_tensors
        grads = qp_solve_vjp(P, A, l, u, x, y, status, g.contiguous(), ctx.settings)
        return (*grads, None, None)


def qp_solve_diff(qp: QuadraticProblem, settings: QPSettings = QPSettings(),
                  impl: str = "vmap") -> torch.Tensor:
    """Solve a QP, one problem or a batch, and return x*, differentiably:
    ``backward`` of a function of the result reaches P, q, A, l and u by
    the implicit function theorem at the converged active set.  ``impl``
    picks the forward tier of a batch ("vmap", "fused" or "kernel"); one
    problem runs on the per-problem solver."""
    return _QPSolveDiff.apply(qp.P, qp.q, qp.A, qp.l, qp.u, settings, impl)
