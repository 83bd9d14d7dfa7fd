"""Differentiable NLP layer (twin of ``sqp_solver_tpu/sqp/diff.py``).

``sqp_solve_diff(problem, x0, lam0, settings, impl)`` returns the primal
solution x*, and ``torch.autograd`` differentiates it with respect to the
problem's data (l, u and ``params``) by implicit differentiation of the
NLP's KKT conditions at the converged active set, the NLP extension of
:mod:`sqp_solver_tpu_torch.qp.diff`.

With the active rows A~ of J(x*, theta) and their multipliers nu, the KKT
system is grad f(x*, theta) + J' lam* = 0, c_act(x*, theta) = b~(l, u).
The adjoint (dz_x, dz_nu) solves the symmetric system with the Lagrangian
Hessian H = d2L/dx2 at x*:

    H dz_x + A~' dz_nu = -g,      A~ dz_x = 0

(the polish KKT solve, K2 on CUDA tensors), and

    dl/dtheta = <dz_x, d/dtheta grad_x L> + <dz_nu, d/dtheta c_act>,

one ``torch.func.vjp`` over ``params`` of theta -> (grad_x L(x*, lam*,
theta), act * c(x*, theta)).  The problem's callables are batched, so the
gradient in x of the Lagrangian summed over the batch is each problem's
own.  dl/db~ = -dz_nu goes to l or u by the active bound, 50/50 on
equality rows.  x0 and lam0 get zero gradients: the converged solution
does not depend on the start.  Exact under strict complementarity, LICQ
and second-order sufficiency at x*; a failed adjoint factor or a forward
solve that did not reach SOLVED gives zero gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.qp.polish import active_masks, kkt_solve_schur_refined
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPSettings
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["sqp_solve_diff", "sqp_solve_vjp"]


def _solve(problem, x0, lam0, settings, impl):
    if x0.dim() == 1:
        from sqp_solver_tpu_torch.sqp.solver import sqp_solve

        return sqp_solve(problem, x0, lam0, settings)
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch

    return sqp_solve_batch(problem, x0, lam0, settings, impl=impl)


@pin_precision
def sqp_solve_vjp(problem: NonlinearProblem, x, lam, status, g,
                  settings: SQPSettings = SQPSettings(), use_kernel=None):
    """The backward pass of :func:`sqp_solve_diff`: the gradients
    ``(dl, du, dparams)`` of a loss with cotangent ``g`` at the solution
    (x, lam) and forward ``status``, each shaped as the problem's own
    tensor (``dparams`` None without params).  ``use_kernel`` picks the
    adjoint solve's route, as in
    :func:`~sqp_solver_tpu_torch.qp.polish.kkt_solve_schur_refined`."""
    from torch import func

    from sqp_solver_tpu_torch.sqp.common import batched_callables

    single = x.dim() == 1
    if single:  # one problem is a batch of one (its params carry the leading 1)
        x, lam, g = x.unsqueeze(0), lam.unsqueeze(0), g.unsqueeze(0)
    l, u, params = problem.l, problem.u, problem.params
    _, _, _, c_lin, hess = batched_callables(problem, settings)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cv, J = c_lin(x)
    # the classification the solver's polish uses, at the shifted bounds;
    # the Hessian takes the multipliers of the active rows alone
    eq, low, up = active_masks(l - cv, u - cv, lam)
    act = eq | low | up
    lam_m = torch.where(act, lam, zero)
    H = hess(x, lam_m)
    J_m = torch.where(act.unsqueeze(-1), J, zero)
    dz_x, dz_nu, fail = kkt_solve_schur_refined(
        H, J_m, act, -g, torch.zeros_like(lam), delta=settings.polish_delta,
        sweeps=settings.polish_sweeps, use_kernel=use_kernel)
    ok = (~fail & (status.reshape(fail.shape) == 0)).unsqueeze(-1)
    dz_x = torch.where(ok, dz_x, zero)
    dz_nu = torch.where(ok & act, dz_nu, zero)
    db = -dz_nu
    half = torch.where(eq, 0.5 * db, zero)
    dl = torch.where(low, db, zero) + half
    du = torch.where(up, db, zero) + half

    dparams = None
    if params is not None:
        f_raw, c_raw = problem.objective, problem.constraint

        def kkt_pieces(th):
            def lagr(xx):
                return (f_raw(xx, th) + (lam_m * c_raw(xx, th)).sum(-1)).sum()

            return func.grad(lagr)(x), torch.where(act, c_raw(x, th), zero)

        _, vjp_fn = func.vjp(kkt_pieces, params)
        (dparams,) = vjp_fn((dz_x, dz_nu))
    if single:
        dl, du = dl[0], du[0]
    # bounds shared by the batch take the sum of the problems' gradients
    return dl.sum_to_size(l.shape), du.sum_to_size(u.shape), dparams


class _SQPSolveDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l, u, params, x0, lam0, problem, settings, impl):
        with torch.no_grad():
            res = _solve(problem, x0, lam0, settings, impl)
        ctx.problem, ctx.settings = problem, settings
        ctx.has_lam0 = lam0 is not None
        ctx.save_for_backward(res.x, res.lam, res.info.status)
        return res.x

    @staticmethod
    def backward(ctx, g):
        x, lam, status = ctx.saved_tensors
        dl, du, dparams = sqp_solve_vjp(ctx.problem, x, lam, status, g.contiguous(),
                                        ctx.settings)
        dlam0 = torch.zeros_like(lam) if ctx.has_lam0 else None
        return dl, du, dparams, torch.zeros_like(x), dlam0, None, None, None


def sqp_solve_diff(problem: NonlinearProblem, x0: torch.Tensor,
                   lam0: Optional[torch.Tensor] = None,
                   settings: SQPSettings = SQPSettings(), impl: str = "fused") -> torch.Tensor:
    """Solve an NLP, one problem (``x0`` (n,)) or a batch (``x0`` (B, n)),
    and return x*, differentiably: ``backward`` of a function of the
    result reaches ``problem.l``, ``problem.u`` and ``problem.params`` (a
    tensor with the leading batch axis, of 1 for one problem) by the
    implicit function theorem at the converged active set.  ``impl`` picks
    the forward tier of a batch ("vmap" or "fused").  The backward pass
    differentiates the raw ``objective`` and ``constraint`` callables, so
    both must be given."""
    if problem.objective is None or problem.constraint is None:
        raise ValueError(
            "sqp_solve_diff requires the raw `objective` and `constraint` callables: "
            "the backward pass re-linearizes the NLP KKT system with torch.func of "
            "those callables.  Problems built from only the closed-form *_linearized "
            "hooks solve fine forward (sqp_solve) but cannot be differentiated through."
        )
    return _SQPSolveDiff.apply(problem.l, problem.u, problem.params, x0, lam0, problem,
                               settings, impl)
