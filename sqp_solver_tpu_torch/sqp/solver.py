"""The per-problem SQP solver, the reference-semantics tier (twin of
``sqp_solver_tpu/sqp/solver.py``): Algorithm 18.3 of Nocedal & Wright
(reference ``src/sqp.cpp:27-343``), linearize, damped BFGS, positive
definiteness repair, the ADMM QP subproblem, the optional second-order
correction, the l1 merit line search, the step and termination.

The JAX package writes one ``lax.while_loop`` per solve and batches it
with ``jax.vmap``.  Here the shared batch-first outer loop
(:func:`sqp_solver_tpu_torch.sqp.common.sqp_outer_loop`) runs it as a
masked loop that ends when no problem is left active, with the tier's
own subproblem step: each while loop of the JAX tier (the posdef repair,
the inner QP of :mod:`sqp_solver_tpu_torch.qp.admm`, the line search) is
a masked loop too, so each problem's iterates, counts and status are
those of a solve of that problem alone.  Deliberate upgrades over the
reference, as in the JAX package: the inner QP warm-starts from the
previous outer iteration, and a problem that turns non-finite is frozen
with status NUMERICAL_ISSUES.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sqp_solver_tpu_torch.qp.admm import qp_solve_masked
from sqp_solver_tpu_torch.qp.types import QuadraticProblem
from sqp_solver_tpu_torch.sqp import common
from sqp_solver_tpu_torch.sqp.bfgs import bfgs_update
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPInfo, SQPResult, SQPSettings
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["sqp_solve"]


@pin_precision
def sqp_solve(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve ``min f(x)  s.t.  l <= c(x) <= u`` from ``x0``.

    ``x0`` (n,) is one problem, a batch of one: the problem's batched
    callables then see x (1, n) and its ``params`` (if any) carry a
    leading 1; the result comes back without the batch axis, as the JAX
    ``sqp_solve``'s does, and ``iteration_callback`` sees (n,) and (m,).
    ``x0`` (B, n) solves a batch.  ``settings.qp_impl`` and
    ``settings.schedule`` are not read: the inner QP is the per-problem
    tier's, and every loop exits early."""
    settings.validate()
    single = x0.dim() == 1
    if single:
        x0 = x0.unsqueeze(0)
        lam0 = None if lam0 is None else lam0.unsqueeze(0)
        cb = settings.iteration_callback
        if cb is not None:
            settings = dataclasses.replace(
                settings, iteration_callback=lambda x, lam, k: cb(x[0], lam[0], k))
    # subproblem infeasibility certificates are off on every SQP tier
    inner = dataclasses.replace(settings.qp, check_infeasibility=False)

    def solve_subproblem(s, Bm, lqp, uqp, warm):
        return qp_solve_masked(QuadraticProblem(P=Bm, q=s.grad_obj, A=s.J, l=lqp, u=uqp),
                               inner, warm, s.active)

    def step(s: common.SubproblemInputs):
        # damped BFGS, reset to I on iteration 1 and after a failed line
        # search, skipped for negligible steps (reference src/sqp.cpp:161-170)
        Bm = common.posdef_repair(
            bfgs_update(s.B, s.step_prev, s.delta_grad_L, s.reset, s.upd), s.active)
        # the QP subproblem, bounds shifted by the constraint value
        # (reference src/sqp.cpp:189-199)
        res = solve_subproblem(s, Bm, s.l - s.c_val, s.u - s.c_val, s.warm)
        qp_it = res.info.iter
        if settings.second_order_correction:
            # re-solve with the bounds corrected by the constraint curvature
            # at x + p, unconditionally (reference quirk Q6, src/sqp.cpp:244-276)
            d = s.c_of(s.x + res.x) - torch.matmul(s.J, res.x.unsqueeze(-1)).squeeze(-1)
            warm = res.state if settings.qp_warm_start else s.warm
            res = solve_subproblem(s, Bm, s.l - d, s.u - d, warm)
            qp_it = qp_it + res.info.iter
        Bm = torch.where(s.active[:, None, None], Bm, s.B)
        return res.x, res.y, Bm, res.state, qp_it

    out = common.sqp_outer_loop(problem, x0, lam0, settings, step, early_exit=True)
    if not single:
        return out
    info = SQPInfo(*(getattr(out.info, k)[0] for k in (
        "status", "iter", "qp_solver_iter", "primal_step_norm", "dual_step_norm")))
    trace = None if out.trace is None else {k: v[:, 0] for k, v in out.trace.items()}
    return SQPResult(x=out.x[0], lam=out.lam[0], info=info, trace=trace)
