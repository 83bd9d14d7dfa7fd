"""Shared SQP blocks (twin of ``sqp_solver_tpu/sqp/common.py``): the l1
merit weight and line search of reference ``src/sqp.cpp:277-319``, the
batched outer loop of Algorithm 18.3 that every SQP tier shares (the
per-problem tier with its while loops as masked loops), and their
Newton-KKT polish epilogue.  Batch-first: reductions run
over the last axis, Jacobians are (B, m, n) and Hessians (B, n, n)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from sqp_solver_tpu_torch.qp.types import QPState
from sqp_solver_tpu_torch.utils.host import any_live
from sqp_solver_tpu_torch.sqp.types import (
    NonlinearProblem,
    SQPInfo,
    SQPResult,
    SQPSettings,
    SQPStatus,
)

__all__ = [
    "constraint_norm",
    "max_violation",
    "merit_weight",
    "line_search_scan",
    "line_search_while",
    "merit_line_search",
    "not_posdef",
    "posdef_repair",
    "batched_callables",
    "SubproblemInputs",
    "StepResult",
    "HessianForm",
    "DENSE_HESSIAN",
    "sqp_outer_loop",
    "polish_nlp",
]


def _linf(v):
    return v.abs().amax(dim=-1)


def constraint_norm(cv, l, u, tiny):
    """l1 violation of l <= c <= u (reference src/sqp.cpp:311-319)."""
    return (
        tiny
        + torch.clamp_min(l - cv, 0.0).sum(-1)
        + torch.clamp_min(cv - u, 0.0).sum(-1)
    )


def max_violation(cv, l, u):
    """linf violation (reference src/sqp.cpp:330-343)."""
    return torch.clamp_min(
        torch.maximum((l - cv).amax(dim=-1), (cv - u).amax(dim=-1)), 0.0
    )


def merit_weight(mu_prev, gp, pBp, constr_l1, lam_qp, rho, tiny):
    """l1 penalty weight, monotone: the reference's merit-model formula where
    the violation is meaningful, the exactness bound 1.5 ||lambda||_inf
    (N&W Thm 17.3) and the previous weight."""
    meaningful = constr_l1 > 1e4 * tiny
    raw = (gp + 0.5 * pBp) / ((1.0 - rho) * constr_l1)
    model_mu = torch.where(meaningful, torch.clamp_min(raw, 0.0), torch.zeros_like(raw))
    dual_mu = 1.5 * _linf(lam_qp)
    return torch.maximum(mu_prev, torch.maximum(model_mu, dual_mu))


def line_search_scan(eval_merit, batch_shape, dtype, phi, D, eta, tau, max_iter,
                     device=None):
    """Backtracking on the l1 merit function as a fixed-trip loop of
    ``max_iter - 1`` evaluations (reference src/sqp.cpp:294-306).  Returns
    ``(alpha, accepted)``; a problem that never passed Armijo keeps its last
    (smallest) alpha and ``accepted`` False."""
    alpha = torch.ones(batch_shape, dtype=dtype, device=device)
    accepted = torch.zeros(batch_shape, dtype=torch.bool, device=device)
    for _ in range(max_iter - 1):
        phi_step = eval_merit(alpha)
        ok = phi_step <= phi + alpha * eta * D
        accepted = accepted | ok
        alpha = torch.where(accepted, alpha, tau * alpha)
    return alpha, accepted


def line_search_while(eval_merit, batch_shape, dtype, phi, D, eta, tau, max_iter,
                      device=None, active=None):
    """The same backtracking as a masked while loop, the per-problem tier's
    form (JAX ``sqp/common.py:137-157``): trips from i = 1 while i <
    ``max_iter``, each problem stopping at its first accepted step, and the
    loop at the trip where none is left searching (one host check a trip).
    A problem that never passed Armijo keeps its last alpha: the failed
    step is taken (reference src/sqp.cpp:294-306).  Problems outside
    ``active`` do not search.  Returns ``(alpha, accepted)``."""
    alpha = torch.ones(batch_shape, dtype=dtype, device=device)
    accepted = torch.zeros(batch_shape, dtype=torch.bool, device=device)
    searching = torch.ones(batch_shape, dtype=torch.bool, device=device)
    if active is not None:
        searching = searching & active
    for _ in range(1, max_iter):
        live = searching & ~accepted
        if not any_live(live):
            break
        ok = eval_merit(alpha) <= phi + alpha * eta * D
        accepted = torch.where(live, ok, accepted)
        alpha = torch.where(live & ~ok, tau * alpha, alpha)
    return alpha, accepted


def not_posdef(M):
    """Per problem of a batch (..., n, n): M has no Cholesky factor."""
    L, info = torch.linalg.cholesky_ex(M)
    return (info > 0) | torch.isnan(L).flatten(-2).any(-1)


def posdef_repair(Bm: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Escalating diagonal shift until the Cholesky factor exists
    (reference src/sqp.cpp:172-181: tau = 1e-3, x10 each try, at most 40
    tries), per problem of a batch (B, n, n), as a masked loop; a B with a
    NaN becomes the identity.  Problems outside ``active`` are not shifted."""
    eye = torch.eye(Bm.shape[-1], dtype=Bm.dtype, device=Bm.device)
    Bm = torch.where(torch.isnan(Bm).flatten(-2).any(-1)[..., None, None], eye, Bm)
    tau = 1e-3
    for _ in range(40):
        need = not_posdef(Bm)
        if active is not None:
            need = need & active
        if not any_live(need):
            break
        Bm = torch.where(need[..., None, None], Bm + tau * eye, Bm)
        tau *= 10.0
    return Bm


def merit_line_search(f_of, c_of, l, u, tiny, settings, x, p, mu, obj, grad_obj, c_val,
                      early_exit: bool = False, active=None):
    """The line search on the l1 merit phi(x) = f(x) + mu
    ||violation(c(x))||_1 along p from x, with the directional derivative
    grad_f'p - mu ||violation(c(x))||_1: :func:`line_search_scan`, or with
    ``early_exit`` :func:`line_search_while` over the ``active`` problems
    (the same steps)."""
    constr_l1 = constraint_norm(c_val, l, u, tiny)
    phi = obj + mu * constr_l1
    D = (grad_obj * p).sum(-1) - mu * constr_l1

    def eval_merit(alpha):
        x_step = x + alpha.unsqueeze(-1) * p
        return f_of(x_step) + mu * constraint_norm(c_of(x_step), l, u, tiny)

    args = (eval_merit, x.shape[:-1], x.dtype, phi, D, settings.eta, settings.tau,
            settings.line_search_max_iter)
    if early_exit:
        return line_search_while(*args, device=x.device, active=active)
    return line_search_scan(*args, device=x.device)


def _vdot(a, b):
    return (a * b).sum(-1)


def _mv(M, v):
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def batched_callables(problem: NonlinearProblem, settings: SQPSettings):
    """(f_lin, f_of, c_of, c_lin, hess) as batched functions of x (B, n),
    with ``torch.func`` supplying every derivative the problem has no hook
    for."""
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


class SubproblemInputs(NamedTuple):
    """What a tier's subproblem step reads in one outer iteration."""

    k: int                      # outer iteration, from 1
    active: torch.Tensor        # (B,) problems still iterating
    x: torch.Tensor             # (B, n)
    grad_obj: torch.Tensor      # (B, n)
    c_val: torch.Tensor         # (B, m)
    J: torch.Tensor             # (B, m, n)
    l: torch.Tensor             # (B, m) constraint bounds
    u: torch.Tensor
    B: torch.Tensor             # Hessian estimate of the last iteration, in the tier's form
    step_prev: torch.Tensor     # (B, n) last accepted step
    delta_grad_L: torch.Tensor  # (B, n) change of the Lagrangian gradient
    reset: torch.Tensor         # (B,) BFGS reset to I, masked by `active`
    upd: torch.Tensor           # (B,) BFGS update, masked by `active`
    warm: QPState               # the QP warm start (zeros without qp_warm_start)
    c_of: Callable              # batched c(x), for the second-order correction


class StepResult(NamedTuple):
    """What a tier's subproblem step returns for one outer iteration."""

    p: torch.Tensor             # (B, n) the step
    lam_qp: torch.Tensor        # (B, m) the QP multipliers
    B: torch.Tensor             # the Hessian estimate to carry, in the tier's form
    state: QPState              # the next QP warm start
    qp_iter: torch.Tensor       # (B,) this iteration's QP iterations
    ls_fail: Optional[torch.Tensor] = None  # (B,) force a failed line search


class HessianForm(NamedTuple):
    """How a tier holds its Hessian estimate: ``init(B, n, dtype, device)``
    its value at the first iteration, ``pbp(H, p)`` p'Hp (B,), and
    ``dense(H)`` the (B, n, n) matrix the polish epilogue falls back to
    where the true Lagrangian Hessian is NaN."""

    init: Callable
    pbp: Callable
    dense: Callable


DENSE_HESSIAN = HessianForm(
    init=lambda B, n, dtype, device: torch.eye(n, dtype=dtype, device=device)
    .expand(B, n, n).contiguous(),
    pbp=lambda H, p: _vdot(p, _mv(H, p)),
    dense=lambda H: H,
)


def sqp_outer_loop(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor],
    settings: SQPSettings,
    step: Callable,
    hessian: HessianForm = DENSE_HESSIAN,
    early_exit: bool = False,
) -> SQPResult:
    """Algorithm 18.3 over a batch ``x0`` (B, n): termination, merit weight,
    line search, the freeze of non-finite problems, masked carry-over,
    trace, ``iteration_callback`` and the polish epilogue, shared by the
    SQP tiers.  ``step(SubproblemInputs)`` is the tier's own part (the
    BFGS update, the QP subproblem and its optional second-order
    correction) and returns the fields of :class:`StepResult`; its Hessian
    estimate is carried into the next iteration as it comes, and its
    ``ls_fail`` marks problems whose line search counts as failed whatever
    it found (the next iteration then resets their BFGS estimate).
    ``hessian`` says how the tier holds its estimate (dense (B, n, n) by
    default).  ``early_exit`` gives the per-problem tier's while loops
    whatever ``settings.schedule``: the loop ends at the first iteration
    with no problem left active, and the line search backtracks while any
    active problem has not yet accepted (:func:`line_search_while`)."""
    dtype, dev = x0.dtype, x0.device
    B, n = x0.shape
    m = problem.l.shape[-1]
    l = problem.l.expand(B, m).contiguous()
    u = problem.u.expand(B, m).contiguous()
    tiny = torch.finfo(dtype).eps
    if lam0 is None:
        lam0 = torch.zeros((B, m), dtype=dtype, device=dev)

    f_lin, f_of, c_of, c_lin, hess_raw = batched_callables(problem, settings)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    x, lam = x0, lam0
    Bm = hessian.init(B, n, dtype, dev)
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
    trace = None
    if settings.record_trace:
        T = settings.max_iter
        trace = dict(x=zeros(T, B, n), lam=zeros(T, B, m), alpha=zeros(T, B),
                     primal_step_norm=zeros(T, B), dual_step_norm=zeros(T, B))
    if settings.iteration_callback is not None:
        # the reference calls the hook once with the initial state
        settings.iteration_callback(x, lam, 0)

    for k in range(1, settings.max_iter + 1):
        active = ~done & ~failed
        if (early_exit or settings.schedule == "early_exit") and not any_live(active):
            break
        obj, grad_obj = f_lin(x)
        c_val, J = c_lin(x)
        grad_L_here = grad_obj + torch.matmul(lam.unsqueeze(-2), J).squeeze(-2)
        if settings.termination == "kkt":
            kkt_ok = (_linf(grad_L_here) <= settings.eps_dual) & (
                max_violation(c_val, l, u) <= settings.eps_prim)
            done = done | (active & kkt_ok)
            active = active & ~kkt_ok

        # damped BFGS masks, reset on iteration 1 and after a failed line
        # search; masked by `active` so inactive problems keep their B
        tiny_step = _linf(step_prev) <= 1e3 * tiny * (1.0 + _linf(x))
        reset = (torch.full_like(active, k == 1) | ls_failed) & active
        upd = ~tiny_step & active
        warm = qp_state if settings.qp_warm_start else QPState.zeros(
            B, n, m, dtype=dtype, device=dev)
        p, lam_qp, B_new, qp_state_next, qp_it, ls_fail = StepResult(*step(SubproblemInputs(
            k, active, x, grad_obj, c_val, J, l, u, Bm, step_prev, grad_L_here - grad_L,
            reset, upd, warm, c_of)))
        qp_iter = qp_iter + torch.where(active, qp_it, 0)

        p_lam = lam_qp - lam
        mu = torch.where(
            active,
            merit_weight(mu, _vdot(grad_obj, p), hessian.pbp(B_new, p),
                         constraint_norm(c_val, l, u, tiny), lam_qp, settings.rho, tiny),
            mu,
        )
        alpha, ls_ok = merit_line_search(f_of, c_of, l, u, tiny, settings, x, p, mu,
                                         obj, grad_obj, c_val, early_exit, active)
        if ls_fail is not None:
            ls_ok = ls_ok & ~ls_fail
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
            conv = ((pn <= settings.eps_prim) & (dn <= settings.eps_dual)
                    & (max_violation(c_of(x_new), l, u) <= settings.eps_prim))
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
        qp_state = QPState(*(torch.where(a1, new, old) for new, old in (
            (qp_state_next.x, qp_state.x), (qp_state_next.z, qp_state.z),
            (qp_state_next.y, qp_state.y))))
        ls_failed = torch.where(active, ~ls_ok, ls_failed)
        it = torch.where(active, k, it)
        failed = failed | (active & bad)
        prim_norm = torch.where(active, pn, prim_norm)
        dual_norm = torch.where(active, dn, dual_norm)

    if settings.polish:
        def hess_fn(xx, ll):
            # the true Lagrangian Hessian, the BFGS estimate where it is NaN
            H = hess_raw(xx, ll)
            bad = torch.isnan(H).flatten(1).any(-1)
            return torch.where(bad[:, None, None], hessian.dense(Bm), H)

        x, lam, kkt_rescued = polish_nlp(x, lam, l, u, f_lin, c_lin, hess_fn, settings)
    else:
        kkt_rescued = zeros(B, dt=torch.bool)

    status = torch.where(
        failed, int(SQPStatus.NUMERICAL_ISSUES),
        torch.where(done | kkt_rescued, int(SQPStatus.SOLVED), int(SQPStatus.MAX_ITER_EXCEEDED)),
    ).to(torch.int32)
    info = SQPInfo(status=status, iter=it, qp_solver_iter=qp_iter,
                   primal_step_norm=prim_norm, dual_step_norm=dual_norm)
    return SQPResult(x=x, lam=lam, info=info, trace=trace)


def polish_nlp(x_out, lam_out, l, u, f_lin, c_lin, hess_fn, settings):
    """Polish epilogue of the SQP tiers: ``polish_passes`` Newton-KKT steps
    on the guessed active set with the true Lagrangian Hessian, one
    polish-KKT kernel call per pass, accepted per problem where the
    re-linearized KKT error max(stationarity, violation) improves.  It is
    the twin of both JAX epilogues, ``polish_nlp`` and the kernel tier's
    ``polish_nlp_t``: the kernel reads H and J from a per-problem
    workspace above its shared-memory envelope, so no size needs a second
    route.

    * ``f_lin(x) -> (obj (B,), grad (B, n))``
    * ``c_lin(x) -> (c (B, m), J (B, m, n))``
    * ``hess_fn(x, lam) -> (B, n, n)``, NaN fallback already applied

    Every pass factors fresh: reusing the factor across passes under
    re-linearization stalls the sweeps (JAX ``sqp/common.py:274-281``).
    Returns ``(x, lam, kkt_rescued)``; ``kkt_rescued`` flags problems whose
    final point meets the KKT tolerances.
    """
    from sqp_solver_tpu_torch.ops.qp_kernel import polish_kkt_kernel
    from sqp_solver_tpu_torch.qp.polish import guess_active_set

    def stat_of(g, J, ll):
        return _linf(g + torch.matmul(ll.unsqueeze(-2), J).squeeze(-2))

    kkt_rescued = torch.zeros(x_out.shape[:-1], dtype=torch.bool, device=x_out.device)
    stat_f = viol_f = None
    # linearize once; later passes reuse the scoring step's linearization
    # of whichever point each problem accepted
    _, grad_f = f_lin(x_out)
    c_f, J_f = c_lin(x_out)
    for pol_pass in range(settings.polish_passes):
        act, b_t = guess_active_set(l - c_f, u - c_f, lam_out)
        H = hess_fn(x_out, lam_out).contiguous()
        out = polish_kkt_kernel(
            H, J_f, act, -grad_f, b_t, lam_out,
            delta=settings.polish_delta, sweeps=settings.polish_sweeps,
        )
        x_pol = x_out + out.x
        lam_pol = torch.where(act, out.nu, torch.zeros_like(out.nu))

        bad = torch.isnan(x_pol).any(-1) | torch.isnan(lam_pol).any(-1) | out.fail
        _, g_p = f_lin(x_pol)
        c_p, J_p = c_lin(x_pol)
        stat_p = stat_of(g_p, J_p, lam_pol)
        viol_p = max_violation(c_p, l, u)
        if pol_pass == 0:
            stat_o = stat_of(grad_f, J_f, lam_out)
            viol_o = max_violation(c_f, l, u)
        else:
            stat_o, viol_o = stat_f, viol_f
        better = (torch.maximum(stat_p, viol_p) < torch.maximum(stat_o, viol_o)) & ~bad
        b1 = better.unsqueeze(-1)
        x_out = torch.where(b1, x_pol, x_out)
        lam_out = torch.where(b1, lam_pol, lam_out)
        stat_f = torch.where(better, stat_p, stat_o)
        viol_f = torch.where(better, viol_p, viol_o)
        kkt_rescued = (stat_f <= settings.eps_dual) & (viol_f <= settings.eps_prim)
        if pol_pass + 1 < settings.polish_passes:
            grad_f = torch.where(b1, g_p, grad_f)
            c_f = torch.where(b1, c_p, c_f)
            J_f = torch.where(b1.unsqueeze(-1), J_p, J_f)
    return x_out, lam_out, kkt_rescued
