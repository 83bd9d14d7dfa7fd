"""Shared SQP blocks (twin of ``sqp_solver_tpu/sqp/common.py``): the l1
merit weight and line search of reference ``src/sqp.cpp:277-319`` and the
Newton-KKT polish epilogue.  Batch-first: reductions run over the last
axis, Jacobians are (B, m, n) and Hessians (B, n, n)."""

from __future__ import annotations

import torch

__all__ = [
    "constraint_norm",
    "max_violation",
    "merit_weight",
    "line_search_scan",
    "polish_nlp_t",
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


def polish_nlp_t(x_out, lam_out, l, u, f_lin, c_lin, hess_fn, settings):
    """Polish epilogue of the kernel tier: ``polish_passes`` Newton-KKT
    steps on the guessed active set with the true Lagrangian Hessian, one
    polish-KKT kernel call per pass, accepted per problem where the
    re-linearized KKT error max(stationarity, violation) improves.

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

    if x_out.shape[-1] > 128:
        raise NotImplementedError(
            "polish at n > 128 (the batch-first polish_nlp route) is not ported "
            "(ROADMAP Queue 1, item 'n > 128 polish')"
        )

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
        H = hess_fn(x_out, lam_out)
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
