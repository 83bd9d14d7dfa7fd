"""Solution polish: active-set refinement after ADMM convergence (twin of
``sqp_solver_tpu/qp/polish.py``).

The active set is guessed from the dual signs (equality rows always
active); the ideal active-set KKT system is then solved through the SPD
Schur preconditioner M = P + dI + (1/d) A_m'A_m with refinement sweeps
against the d-free operator (:func:`kkt_solve_schur_refined`), and the
polished candidate is accepted per problem only where its KKT score
improves.  Each pass after the first reclassifies the active set from the
previous pass's result.

Routes of the KKT solve: ``use_kernel`` None or True goes through the
polish-KKT kernel (K2) as one call; ``use_kernel=False`` builds M with
``torch.matmul``, inverts it with the SPD-inverse kernel (K4) and runs one
Newton-Schulz step and the sweeps as matmuls.  CPU tensors take the plain
versions of both kernels.
"""

from __future__ import annotations

import torch

from sqp_solver_tpu_torch.qp.classify import RHO_TOL
from sqp_solver_tpu_torch.qp.types import QPResult, QPSettings, QuadraticProblem

__all__ = [
    "polish_qp",
    "kkt_solve_schur_refined",
    "guess_active_set",
    "active_masks",
    "reclassify_active_set",
]


def _mv(M, v):
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


def _linf(v):
    return v.abs().amax(dim=-1)


def _zero(like):
    return torch.zeros((), dtype=like.dtype, device=like.device)


def active_masks(l, u, y):
    """``(eq, act_low, act_up)``: equality rows (u - l < RHO_TOL) and rows
    whose dual is meaningfully negative / positive."""
    eq = (u - l) < RHO_TOL
    ytol = 1e-5 * (1.0 + y.abs().amax(dim=-1, keepdim=True))
    act_low = (y < -ytol) & ~eq
    act_up = (y > ytol) & ~eq
    return eq, act_low, act_up


def _targets(l, u, eq, act_low, act_up):
    act = act_low | act_up | eq
    zero = _zero(l)
    b = torch.where(
        eq, 0.5 * (l + u), torch.where(act_low, l, torch.where(act_up, u, zero))
    )
    return act, torch.where(act, b, zero)


def guess_active_set(l, u, y):
    """OSQP-style guess from dual signs, equality rows always active.
    Returns ``(act, b)`` with ``b`` the target on active rows, 0 elsewhere."""
    return _targets(l, u, *active_masks(l, u, y))


def reclassify_active_set(l, u, eq, act_low, act_up, nu, Ax_pol):
    """One active-set step from a polish result: promote rows the polished
    x visibly violates, demote active rows whose multiplier came back with
    the wrong sign.  Returns ``(act_low, act_up)``."""
    zero = _zero(l)
    vtol = 1e-9 * (
        1.0
        + torch.maximum(
            torch.where(torch.isfinite(l), l.abs(), zero),
            torch.where(torch.isfinite(u), u.abs(), zero),
        )
    )
    pro_low = torch.isfinite(l) & (Ax_pol < l - vtol) & ~eq
    pro_up = torch.isfinite(u) & (Ax_pol > u + vtol) & ~eq
    stol = 1e-12
    new_low = ((act_low & (nu <= stol)) | pro_low) & ~pro_up
    new_up = ((act_up & (nu >= -stol)) | pro_up) & ~pro_low
    return new_low, new_up


def kkt_solve_schur_refined(P, A_m, act, r1, r2, x0=None, nu0=None,
                            delta: float = 1e-2, sweeps: int = 6, use_kernel=None):
    """Solve the ideal active-set KKT system

        P x + A_m' nu = r1,   A_m x = r2 (active rows),   nu = 0 (inactive)

    for a batch (B leading) or one problem, where ``A_m`` has inactive rows
    zeroed and ``r2`` is zero on inactive rows.  Returns ``(x, nu, fail)``.
    ``x0``/``nu0`` warm-start the sweeps.  ``use_kernel`` picks the route
    (module docstring)."""
    if P.dim() == 2:
        out = kkt_solve_schur_refined(
            P[None], A_m[None], act[None], r1[None], r2[None],
            None if x0 is None else x0[None], None if nu0 is None else nu0[None],
            delta, sweeps, use_kernel,
        )
        return tuple(v[0] for v in out)
    from sqp_solver_tpu_torch.ops.qp_kernel import polish_kkt_kernel, spd_inverse_kernel

    zero = _zero(r1)
    if use_kernel is None or use_kernel:
        out = polish_kkt_kernel(
            P.contiguous(), A_m.contiguous(), act.contiguous(), r1.contiguous(),
            torch.where(act, r2, zero),
            torch.zeros_like(r2) if nu0 is None else nu0.contiguous(),
            delta=delta, sweeps=sweeps, x0=None if x0 is None else x0.contiguous(),
        )
        return out.x, torch.where(act, out.nu, zero), out.fail
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    M = P + delta * eye + (1.0 / delta) * torch.matmul(A_m.mT, A_m)
    Minv, fail = spd_inverse_kernel(M.contiguous())
    # one Newton-Schulz step recovers backsolve-grade accuracy
    Minv = torch.matmul(Minv, 2.0 * eye - torch.matmul(M, Minv))
    x = torch.zeros_like(r1) if x0 is None else x0
    nu = torch.zeros_like(r2) if nu0 is None else torch.where(act, nu0, zero)
    # stacked operand S = [P; A_m]: P v and A_m v in one product, and
    # w = S x carried across sweeps
    S = torch.cat([P, A_m], dim=-2)
    w = _mv(S, x)
    for _ in range(sweeps):
        res2 = torch.where(act, r2 - w[..., n:], zero)
        dx = _mv(Minv, r1 - w[..., :n] - _mtv(A_m, nu - (1.0 / delta) * res2))
        dw = _mv(S, dx)
        nu = nu + torch.where(act, (dw[..., n:] - res2) / delta, zero)
        x = x + dx
        w = w + dw
    return x, nu, fail


def polish_qp(qp: QuadraticProblem, result: QPResult, settings: QPSettings = QPSettings(),
              delta: float = None, refine_steps: int = None, passes: int = None,
              use_kernel=None) -> QPResult:
    """Polish a QP result, batched (B leading) or one problem.

    ``delta``/``refine_steps``/``passes`` default to
    ``settings.polish_delta`` / ``settings.polish_sweeps`` /
    ``settings.polish_passes``; explicit arguments override.
    ``use_kernel`` picks the KKT solve's route (module docstring)."""
    from sqp_solver_tpu_torch.utils.precision import pin_precision

    if delta is None:
        delta = settings.polish_delta
    if refine_steps is None:
        refine_steps = settings.polish_sweeps
    if passes is None:
        passes = settings.polish_passes
    if qp.P.dim() == 2:
        batched = QuadraticProblem(*(v[None] for v in (qp.P, qp.q, qp.A, qp.l, qp.u)))
        res = QPResult(x=result.x[None], y=result.y[None], z=result.z[None],
                       info=result.info)
        out = pin_precision(_polish_impl)(batched, res, delta, refine_steps, passes,
                                          use_kernel)
        return QPResult(x=out.x[0], y=out.y[0], z=out.z[0], info=result.info)
    return pin_precision(_polish_impl)(qp, result, delta, refine_steps, passes, use_kernel)


def _polish_impl(qp, result, delta, refine_steps, passes, use_kernel):
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    x, y, z = result.x, result.y, result.z
    zero = _zero(q)
    fin_l, fin_u = torch.isfinite(l), torch.isfinite(u)

    def kkt_err(xx, yy, Ax):
        # max of stationarity, primal violation and comp-slack violation
        res_d = _linf(_mv(P, xx) + q + _mtv(A, yy))
        viol = torch.maximum(
            torch.where(fin_l, l - Ax, zero).amax(-1),
            torch.where(fin_u, Ax - u, zero).amax(-1),
        )
        at_l = Ax <= l + 1e-6 * (1.0 + l.abs())
        at_u = Ax >= u - 1e-6 * (1.0 + u.abs())
        dsv = (
            torch.where(~at_u, torch.clamp_min(yy, 0.0), zero)
            + torch.where(~at_l, torch.clamp_min(-yy, 0.0), zero)
        ).amax(-1)
        return torch.maximum(torch.maximum(res_d, viol), dsv)

    eq, act_low, act_up = active_masks(l, u, y)
    best = (x, y, z)
    best_score = kkt_err(x, y, _mv(A, x))
    x_c, nu_c = x, y  # warm-start carriers across passes
    for p in range(passes):
        act, b = _targets(l, u, eq, act_low, act_up)
        A_m = torch.where(act.unsqueeze(-1), A, zero)
        x_pol, nu, fail = kkt_solve_schur_refined(
            P, A_m, act, -q, b, x0=x_c, nu0=nu_c, delta=delta, sweeps=refine_steps,
            use_kernel=use_kernel,
        )
        y_pol = torch.where(act, nu, zero)
        Ax_pol = _mv(A, x_pol)
        bad_pol = torch.isnan(x_pol).any(-1) | fail
        score_new = kkt_err(x_pol, y_pol, Ax_pol)
        better = (score_new < best_score) & ~bad_pol
        b1 = better.unsqueeze(-1)
        best = (
            torch.where(b1, x_pol, best[0]),
            torch.where(b1, y_pol, best[1]),
            torch.where(b1, torch.clamp(Ax_pol, min=l, max=u), best[2]),
        )
        best_score = torch.where(better, score_new, best_score)
        if p + 1 < passes:
            act_low, act_up = reclassify_active_set(l, u, eq, act_low, act_up, y_pol, Ax_pol)
            x_c, nu_c = x_pol, y_pol
    return QPResult(x=best[0], y=best[1], z=best[2], info=result.info)
