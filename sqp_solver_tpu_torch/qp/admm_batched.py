"""Batch-explicit fused ADMM solver (twin of ``sqp_solver_tpu/qp/admm_batched.py``).

The OSQP iteration with an explicit leading batch axis, in chunks of
``seg`` iterations: each chunk and its termination residuals are one
launch of the chunk kernel K5 (:mod:`sqp_solver_tpu_torch.ops.admm_kernel`),
which keeps each problem's fused iteration operator W in shared memory for
the whole chunk.  With ``linear_solver="schur_block_tridiag"`` the chunk is
plain tensor code over the backend's block-Thomas factor instead (the
structured route: the same iterate math, batched small matmuls over the
stages, and the same schedule).  Between chunks plain tensor code applies the per-problem
masks: convergence (``done``), factorization failure, the infeasibility
certificates, the optional complementary-slackness term and safeguarded
Anderson acceleration; every ``adaptive_rho_interval`` iterations a rho
epoch re-estimates rho and refactors the changed problems
(:mod:`sqp_solver_tpu_torch.ops.linear_solver`).

Schedules: ``"fixed"`` runs ceil(max_iter / seg) chunks with no host
synchronisation; ``"early_exit"`` checks once per chunk whether any
problem is still active.  The JAX package decides the rho refactor with a
``lax.cond`` on "any changed"; here the masked refactor runs whenever
another chunk follows an epoch boundary, which gives the same results
without a host sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.ops.admm_kernel import admm_chunk, chunk_stats
from sqp_solver_tpu_torch.ops.linear_solver import _schur_factor, get_linear_solver
from sqp_solver_tpu_torch.qp.admm import _select
from sqp_solver_tpu_torch.qp.classify import RHO_MAX, RHO_MIN, constr_type_init, rho_vec_from_type
from sqp_solver_tpu_torch.qp.types import (
    QPInfo,
    QPResult,
    QPSettings,
    QPState,
    QPStatus,
    QuadraticProblem,
)
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["qp_solve_fused"]


def _check_settings(settings: QPSettings) -> None:
    settings.validate()
    if settings.linear_solver not in ("schur_cholesky", "schur_block_tridiag", "schur_arrow"):
        raise ValueError(
            "qp_solve_fused supports linear_solver='schur_cholesky', "
            "'schur_block_tridiag', or 'schur_arrow'"
        )
    if settings.scaling > 0:
        raise ValueError("call qp_solve_fused through qp_solve_batch for scaling support")


@pin_precision
def qp_solve_fused(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    state: Optional[QPState] = None,
) -> QPResult:
    """Solve a batch of QPs, batch-first (P (B, n, n), q (B, n), A (B, m, n),
    l and u (B, m)); ``state`` warm-starts (x, z, y).  CUDA tensors run
    the chunks through K5 (float32), CPU tensors through its plain version."""
    _check_settings(settings)
    P, A = qp.P.contiguous(), qp.A.contiguous()
    q, l, u = qp.q, qp.l, qp.u
    dtype, dev = q.dtype, q.device
    B, n = q.shape
    m = A.shape[-2]
    D = n + m
    sigma = float(settings.sigma)
    eps_abs, eps_rel = float(settings.eps_abs), float(settings.eps_rel)
    tiny = torch.finfo(dtype).eps

    ctype = constr_type_init(l, u)
    rho_vec = rho_vec_from_type(ctype, settings.rho, dtype)
    if state is None:
        state = QPState.zeros(B, n, m, dtype=dtype, device=dev)

    check = settings.check_termination
    interval0 = settings.adaptive_rho_interval if settings.adaptive_rho else settings.max_iter
    seg = check if check > 0 else min(interval0, settings.max_iter)
    # epoch boundaries are k % interval == 0: round the interval up to a
    # multiple of the chunk length
    interval = -(-interval0 // seg) * seg

    # padded constant vectors (ops/admm_kernel.py)
    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=dev)

    zeros_n = full((B, n), 0.0)
    qv = torch.cat([q, full((B, m), 0.0)], dim=-1)
    sigma_n = full((B, n), sigma)
    lp = torch.cat([full((B, n), -float("inf")), l], dim=-1)
    up = torch.cat([full((B, n), float("inf")), u], dim=-1)
    alpha = float(settings.alpha)

    use_aa = settings.acceleration == "anderson"
    m_aa = settings.anderson_memory

    def padded_rho(rho_vec):
        """(rhop, rhoip, scale1) = ([0; rho], [0; 1/rho], [sigma; rho]): the
        fused operator takes rho .* z - y."""
        return (torch.cat([zeros_n, rho_vec], dim=-1), torch.cat([zeros_n, 1.0 / rho_vec], dim=-1),
                torch.cat([sigma_n, rho_vec], dim=-1))

    def converged(rp, rd, mz, mq):
        return (rp <= eps_abs + eps_rel * mz) & (rd <= eps_abs + eps_rel * mq)

    def anderson_step(s, yp, aa, s_new, yp_new, stats):
        """Safeguarded type-II AA on the chunk map, accepted per problem
        where it lowers the combined relative residual and does not undo
        termination (qp/admm.py's scheme)."""
        from sqp_solver_tpu_torch.qp.anderson import anderson_extrapolate

        u_aa, pairs, aa = anderson_extrapolate(
            aa, torch.cat([s, yp], dim=-1), torch.cat([s_new, yp_new], dim=-1), m_aa)
        x_a = u_aa[:, :n]
        z_a = torch.clamp(u_aa[:, n:D], min=l, max=u)  # keep the box invariant
        y_a = u_aa[:, D + n:]
        stats_a = chunk_stats(P, A, q, x_a, z_a, y_a)

        def comb(st):
            return st[:, 0] / (st[:, 2] + tiny) + st[:, 1] / (st[:, 3] + tiny)

        comb_a = comb(stats_a)
        accept = (
            (pairs > 0) & torch.isfinite(comb_a) & (comb_a < comb(stats))
            & (converged(*stats_a.unbind(-1)) | ~converged(*stats.unbind(-1)))
        )
        a1 = accept.unsqueeze(-1)
        return (torch.where(a1, torch.cat([x_a, z_a], dim=-1), s_new),
                torch.where(a1, torch.cat([zeros_n, y_a], dim=-1), yp_new),
                torch.where(a1, stats_a, stats), aa)

    structured = settings.linear_solver != "schur_cholesky"
    if structured:
        # get_linear_solver raises for schur_arrow, naming its ROADMAP item
        solver = get_linear_solver(settings.linear_solver, settings.block_size,
                                   settings.arrow_width)

        def factor(rho_vec):
            return solver.factor(P, A, sigma, rho_vec)

        def chunk(W, rho_vec, s, yp):
            """``seg`` iterations with the structured solve (the iterate
            math of K5 and of qp/admm.py), then the stats."""
            x, z, y = s[:, :n], s[:, n:], yp[:, n:]
            rho_inv = 1.0 / rho_vec
            for _ in range(seg):
                xt, zt = solver.solve_xz(W, P, A, sigma, rho_vec, sigma * x - q,
                                         z - rho_inv * y, settings.refine_steps)
                xn = alpha * xt + (1.0 - alpha) * x
                z_pre = alpha * zt + (1.0 - alpha) * z
                zn = torch.clamp(z_pre + rho_inv * y, min=l, max=u)
                y = y + rho_vec * (z_pre - zn)
                x, z = xn, zn
            return (torch.cat([x, z], dim=-1), torch.cat([zeros_n, y], dim=-1),
                    chunk_stats(P, A, q, x, z, y))

        W = factor(rho_vec)
        failed = W["diag_nan"]
    else:
        def factor(rho_vec):
            return _schur_factor(P, A, sigma, rho_vec)[0]

        def chunk(W, rho_vec, s, yp):
            return admm_chunk(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp,
                              alpha=alpha, seg=seg)

        W = factor(rho_vec)
        failed = torch.isnan(W).flatten(1).any(-1)
    s = torch.cat([state.x, state.z], dim=-1)
    yp = torch.cat([zeros_n, state.y], dim=-1)
    rho = full((B,), settings.rho)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    res = torch.zeros((B, 4), dtype=dtype, device=dev)  # the last active chunk's stats
    # before any adaptive evaluation the best estimate is the current rho
    rho_estimate = rho.clone()
    # the reference counts the setup rho update too (src/qp.cpp:34)
    rho_updates = torch.ones(B, dtype=torch.int32, device=dev)
    infeas = torch.zeros(B, dtype=torch.int32, device=dev)
    aa = None
    if use_aa:
        from sqp_solver_tpu_torch.qp.anderson import anderson_init

        aa = anderson_init((B,), m_aa, 2 * D, dtype, device=dev)
    if settings.check_infeasibility and check > 0:
        from sqp_solver_tpu_torch.qp.infeasibility import infeasibility_certificates

    rhop, rhoip, scale1 = padded_rho(rho_vec)
    n_chunks = -(-settings.max_iter // seg)
    k = 0
    for _ in range(n_chunks):
        active = ~done & ~failed & (infeas == 0)
        if settings.schedule != "fixed" and not bool(active.any()):
            break
        s_new, yp_new, stats = chunk(W, rho_vec, s, yp)
        if use_aa:
            s_new, yp_new, stats, aa = anderson_step(s, yp, aa, s_new, yp_new, stats)
        if check > 0 and settings.check_infeasibility:
            # OSQP section 3.4 on the chunk's deltas; a certified problem
            # commits this chunk and is frozen from the next one
            prim_inf, dual_inf = infeasibility_certificates(
                P, A, q, l, u, s_new[:, :n] - s[:, :n], yp_new[:, n:] - yp[:, n:],
                settings.eps_pinf, settings.eps_dinf)
            cert = torch.where(prim_inf, 1, torch.where(dual_inf, 2, 0)).to(torch.int32)
            infeas = torch.where(active & (cert > 0), cert, infeas)
        a1 = active.unsqueeze(-1)
        s = torch.where(a1, s_new, s)
        yp = torch.where(a1, yp_new, yp)
        k += seg
        it = torch.where(active, k, it)
        res = torch.where(a1, stats, res)
        if check > 0:
            conv = converged(*stats.unbind(-1))
            if settings.check_comp_slack:
                # z is the projected iterate: clamped rows sit exactly at the
                # bound, so the at-bound test can be razor thin
                z_b, y_b = s[:, n:], yp[:, n:]
                btol = 64.0 * torch.finfo(dtype).eps
                at_l = z_b <= l + btol * (1.0 + l.abs())
                at_u = z_b >= u - btol * (1.0 + u.abs())
                zero = torch.zeros((), dtype=dtype, device=dev)
                dsv = (torch.where(~at_u, torch.clamp_min(y_b, 0.0), zero)
                       + torch.where(~at_l, torch.clamp_min(-y_b, 0.0), zero)).amax(-1)
                conv = conv & (dsv <= eps_abs + eps_rel * y_b.abs().amax(-1))
            done = done | (active & conv)
            if settings.verbose:
                print(f"{k:4d}  active {int(active.sum()):5d}  "
                      f"rp_p50 {float(stats[:, 0].median()):.2e}  "
                      f"rd_p50 {float(stats[:, 1].median()):.2e}")
        if settings.adaptive_rho and k % interval == 0:
            # rho epoch (reference src/qp.cpp:125-144)
            active = ~done & ~failed & (infeas == 0)
            rp = res[:, 0] / (res[:, 2] + tiny)
            rd = res[:, 1] / (res[:, 3] + tiny)
            new_rho = torch.clamp(rho * torch.sqrt(rp / (rd + tiny)), RHO_MIN, RHO_MAX)
            tol = settings.adaptive_rho_tolerance
            changed = ((new_rho < rho / tol) | (new_rho > rho * tol)) & active
            rho = torch.where(changed, new_rho, rho)
            rho_vec = torch.where(changed.unsqueeze(-1),
                                  rho_vec_from_type(ctype, new_rho.unsqueeze(-1), dtype), rho_vec)
            if k < settings.max_iter:  # the factor is read only by a later chunk
                W = _select(changed, factor(rho_vec), W)
                rhop, rhoip, scale1 = padded_rho(rho_vec)
            rho_estimate = torch.where(active, new_rho, rho_estimate)
            rho_updates = rho_updates + changed.to(torch.int32)
            if use_aa:
                # the chunk map changed for refactored problems: their pairs
                # would extrapolate through another fixed point
                aa = dict(aa, prev_ok=aa["prev_ok"] & ~changed,
                          pairs=torch.where(changed, 0, aa["pairs"]))

    status = torch.where(
        failed, int(QPStatus.NUMERICAL_ISSUES),
        torch.where(done, int(QPStatus.SOLVED),
                    torch.where(infeas == 1, int(QPStatus.PRIMAL_INFEASIBLE),
                                torch.where(infeas == 2, int(QPStatus.DUAL_INFEASIBLE),
                                            int(QPStatus.MAX_ITER_EXCEEDED)))),
    ).to(torch.int32)
    info = QPInfo(status=status, iter=torch.clamp_max(it, settings.max_iter),
                  rho_updates=rho_updates, rho_estimate=rho_estimate,
                  res_prim=res[:, 0], res_dual=res[:, 1])
    result = QPResult(x=s[:, :n], y=yp[:, n:], z=s[:, n:], info=info)
    if settings.polish:
        from sqp_solver_tpu_torch.qp.polish import polish_qp

        result = polish_qp(qp, result, settings)
    return result
