"""Kernel-fused batch SQP solver (twin of ``sqp_solver_tpu/sqp/solver_kernel.py``).

Algorithm 18.3 with damped BFGS, posdef repair, l1 merit line search and
optional SOC (reference ``src/sqp.cpp:44-101``), around the SQP-step
kernel: each outer iteration's BFGS update, posdef fallback, Schur factor
and whole warm-started ADMM QP solve run as one kernel launch
(:func:`sqp_solver_tpu_torch.ops.qp_kernel.sqp_step_kernel`).  The polish
epilogue runs one polish-KKT kernel launch per pass.  Only the user
callables and O(B (n + m)) vector arithmetic run as plain tensor ops.

Layout is batch-first throughout: the Hessian estimate is (B, n, n) and
the Jacobian (B, m, n).
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.ops.qp_kernel import sqp_step_kernel
from sqp_solver_tpu_torch.qp.types import QPState
from sqp_solver_tpu_torch.sqp import common
from sqp_solver_tpu_torch.sqp.types import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQPStatus,
)
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


def _vdot(a, b):
    return (a * b).sum(-1)


def _linf(v):
    return v.abs().amax(dim=-1)


def _batched_callables(problem: NonlinearProblem, settings: SQPSettings):
    """(f_lin, c_of, c_lin, hess) as batched functions of x (B, n), with
    ``torch.func`` supplying every derivative the problem has no hook for."""
    from torch import func

    params = problem.params
    f_raw, c_raw = problem.objective, problem.constraint
    p_dim = None if params is None else 0

    def one(fn):
        # a batched callable seen as a function of one problem
        if params is None:
            return lambda xi, pi: fn(xi.unsqueeze(0), None)[0]
        return lambda xi, pi: fn(xi.unsqueeze(0), pi.unsqueeze(0))[0]

    def f_of(x):
        return f_raw(x, params)

    def c_of(x):
        return c_raw(x, params)

    # the kernels take contiguous operands: autodiff may hand back
    # expanded views (the gradient of a sum is a broadcast constant)
    if problem.objective_linearized is not None:
        def f_lin(x):
            obj, grad = problem.objective_linearized(x, params)
            return obj, grad.contiguous()
    else:
        gv = func.vmap(func.grad_and_value(one(f_raw)), in_dims=(0, p_dim))

        def f_lin(x):
            grad, value = gv(x, params)  # torch.func returns (grad, value)
            return value, grad.contiguous()

    if problem.constraint_linearized is not None:
        def c_lin(x):
            cv, J = problem.constraint_linearized(x, params)
            return cv, J.contiguous()
    else:
        jac = func.jacfwd if settings.jacobian_mode == "fwd" else func.jacrev
        jb = func.vmap(jac(one(c_raw)), in_dims=(0, p_dim))

        def c_lin(x):
            return c_of(x), jb(x, params).contiguous()

    if problem.lagrangian_hessian is not None:
        def hess(x, lam):
            return problem.lagrangian_hessian(x, lam, params).contiguous()
    else:
        f1, c1 = one(f_raw), one(c_raw)

        def lagr(xi, li, pi):
            return f1(xi, pi) + (li * c1(xi, pi)).sum()

        hb = func.vmap(func.hessian(lagr, argnums=0), in_dims=(0, 0, p_dim))

        def hess(x, lam):
            return hb(x, lam, params).contiguous()

    return f_lin, f_of, c_of, c_lin, hess


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
    dtype, dev = x0.dtype, x0.device
    B, n = x0.shape
    m = problem.l.shape[-1]
    l = problem.l.expand(B, m).contiguous()
    u = problem.u.expand(B, m).contiguous()
    tiny = torch.finfo(dtype).eps
    if lam0 is None:
        lam0 = torch.zeros((B, m), dtype=dtype, device=dev)

    f_lin, f_of, c_of, c_lin, hess_raw = _batched_callables(problem, settings)

    def constraint_norm(cv):
        return common.constraint_norm(cv, l, u, tiny)

    def line_search(x, p, mu, obj, grad_obj, c_val):
        constr_l1 = constraint_norm(c_val)
        gp = _vdot(grad_obj, p)
        phi = obj + mu * constr_l1
        D = gp - mu * constr_l1

        def eval_merit(alpha):
            x_step = x + alpha.unsqueeze(-1) * p
            return f_of(x_step) + mu * constraint_norm(c_of(x_step))

        return common.line_search_scan(
            eval_merit, (B,), dtype, phi, D, settings.eta, settings.tau,
            settings.line_search_max_iter, device=dev,
        )

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    x, lam = x0, lam0
    Bm = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n).contiguous()
    grad_L = zeros(B, n)
    step_prev = zeros(B, n)
    qp_state = QPState.zeros(B, n, m, dtype=dtype, device=dev)
    mu = zeros(B)
    ls_failed = zeros(B, dt=torch.bool)
    it = zeros(B, dt=torch.int32)
    done = zeros(B, dt=torch.bool)
    failed = zeros(B, dt=torch.bool)
    qp_iter = zeros(B, dt=torch.int32)
    prim_norm = zeros(B)
    dual_norm = zeros(B)
    if settings.record_trace:
        T = settings.max_iter
        trace = dict(x=zeros(T, B, n), lam=zeros(T, B, m), alpha=zeros(T, B),
                     primal_step_norm=zeros(T, B), dual_step_norm=zeros(T, B))
    else:
        trace = None
    if settings.iteration_callback is not None:
        # the reference calls the hook once with the initial state
        settings.iteration_callback(x, lam, 0)

    soc = settings.second_order_correction
    for k in range(1, settings.max_iter + 1):
        active = ~done & ~failed
        if settings.schedule == "early_exit" and not bool(active.any()):
            break
        obj, grad_obj = f_lin(x)
        c_val, J = c_lin(x)
        grad_L_here = grad_obj + torch.matmul(lam.unsqueeze(-2), J).squeeze(-2)

        if settings.termination == "kkt":
            kkt_ok = (_linf(grad_L_here) <= settings.eps_dual) & (
                common.max_violation(c_val, l, u) <= settings.eps_prim
            )
            newly_done = active & kkt_ok
            done = done | newly_done
            active = active & ~newly_done

        # BFGS masks (the update runs inside the kernel); masked by
        # `active` so inactive problems pass their B through unchanged
        delta_grad_L = grad_L_here - grad_L
        tiny_step = _linf(step_prev) <= 1e3 * tiny * (1.0 + _linf(x))
        reset = (torch.full_like(active, k == 1) | ls_failed) & active
        upd = ~tiny_step & active

        warm = qp_state if settings.qp_warm_start else QPState.zeros(
            B, n, m, dtype=dtype, device=dev)
        step = sqp_step_kernel(
            Bm, J, grad_obj, l - c_val, u - c_val, step_prev, delta_grad_L,
            reset, upd, active, warm.x, warm.z, warm.y, settings.qp,
            do_bfgs=True, want_minv=soc,
        )
        p, z_qp, lam_qp, B_new = step.p, step.z, step.y, step.B
        qp_iter = qp_iter + torch.where(active, step.iter, 0)
        qp_state_next = QPState(x=p, z=z_qp, y=lam_qp)

        if soc:
            # factor reuse: only l, u change between the QP and its SOC
            # re-solve, so Minv and its rho carry over
            d = c_of(x + p) - torch.matmul(J, p.unsqueeze(-1)).squeeze(-1)
            warm = qp_state_next if settings.qp_warm_start else QPState.zeros(
                B, n, m, dtype=dtype, device=dev)
            step2 = sqp_step_kernel(
                B_new, J, grad_obj, l - d, u - d, step_prev, delta_grad_L,
                reset, upd, active, warm.x, warm.z, warm.y, settings.qp,
                do_bfgs=False, rho_in=step.rho_factor, minv_in=step.minv,
            )
            p, lam_qp = step2.p, step2.y
            qp_iter = qp_iter + torch.where(active, step2.iter, 0)
            qp_state_next = QPState(x=p, z=step2.z, y=lam_qp)

        p_lam = lam_qp - lam
        pBp = _vdot(p, torch.matmul(B_new, p.unsqueeze(-1)).squeeze(-1))
        mu = torch.where(
            active,
            common.merit_weight(mu, _vdot(grad_obj, p), pBp, constraint_norm(c_val),
                                lam_qp, settings.rho, tiny),
            mu,
        )
        alpha, ls_ok = line_search(x, p, mu, obj, grad_obj, c_val)

        x_new = x + alpha.unsqueeze(-1) * p
        lam_new = lam + alpha.unsqueeze(-1) * p_lam
        step_k = alpha.unsqueeze(-1) * p
        pn = alpha * _linf(p)
        dn = alpha * _linf(p_lam)

        # freeze non-finite problems (inf as well as NaN)
        bad = (~torch.isfinite(x_new)).any(-1) | (~torch.isfinite(lam_new)).any(-1)
        keep = (active & ~bad).unsqueeze(-1)
        x_new = torch.where(keep, x_new, x)
        lam_new = torch.where(keep, lam_new, lam)

        if settings.termination != "kkt":
            conv = (
                (pn <= settings.eps_prim)
                & (dn <= settings.eps_dual)
                & (common.max_violation(c_of(x_new), l, u) <= settings.eps_prim)
            )
            done = done | (active & conv)

        if trace is not None:
            trace["x"][k - 1] = x_new
            trace["lam"][k - 1] = lam_new
            trace["alpha"][k - 1] = torch.where(active, alpha, 0.0)
            trace["primal_step_norm"][k - 1] = pn
            trace["dual_step_norm"][k - 1] = dn
        if settings.iteration_callback is not None:
            settings.iteration_callback(x_new, lam_new, k)

        a1 = active.unsqueeze(-1)
        x, lam = x_new, lam_new
        Bm = B_new
        grad_L = torch.where(a1, grad_L_here, grad_L)
        step_prev = torch.where(a1, step_k, step_prev)
        qp_state = QPState(
            x=torch.where(a1, qp_state_next.x, qp_state.x),
            z=torch.where(a1, qp_state_next.z, qp_state.z),
            y=torch.where(a1, qp_state_next.y, qp_state.y),
        )
        ls_failed = torch.where(active, ~ls_ok, ls_failed)
        it = torch.where(active, k, it)
        failed = failed | (active & bad)
        prim_norm = torch.where(active, pn, prim_norm)
        dual_norm = torch.where(active, dn, dual_norm)

    if settings.polish:
        def hess_fn(xx, ll):
            H = hess_raw(xx, ll)
            # NaN fallback to the BFGS estimate
            H_bad = torch.isnan(H).flatten(1).any(-1)
            return torch.where(H_bad[:, None, None], Bm, H).contiguous()

        x, lam, kkt_rescued = common.polish_nlp_t(
            x, lam, l, u, f_lin, c_lin, hess_fn, settings
        )
    else:
        kkt_rescued = zeros(B, dt=torch.bool)

    status = torch.where(
        failed,
        int(SQPStatus.NUMERICAL_ISSUES),
        torch.where(done | kkt_rescued, int(SQPStatus.SOLVED),
                    int(SQPStatus.MAX_ITER_EXCEEDED)),
    ).to(torch.int32)
    info = SQPInfo(status=status, iter=it, qp_solver_iter=qp_iter,
                   primal_step_norm=prim_norm, dual_step_norm=dual_norm)
    return SQPResult(x=x, lam=lam, info=info, trace=trace)
