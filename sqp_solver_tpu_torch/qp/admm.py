"""The per-problem ADMM QP solver, the reference-semantics tier (twin of
``sqp_solver_tpu/qp/admm.py``, the OSQP loop of reference
``src/qp.cpp:11-157``).

Loop structure, per problem:

    while not done:                              # rho epochs
        factor the KKT system (only if rho changed)
        run one chunk of `seg` ADMM iterations   # unless the factor failed
        while not done and not at an epoch end:
            run one chunk, update residuals, check termination
        estimate rho, decide the refactor

The JAX package writes this as nested ``lax.while_loop``s and batches it
with ``jax.vmap``, which runs every live problem through the body and
keeps the carry of a problem whose condition is false.  Here it is one
batch-first *masked* loop that does just that: each trip of a loop asks
the device whether any problem is still live (one host check,
:mod:`sqp_solver_tpu_torch.utils.host`), runs the body on the batch, and
commits each problem's new carry with a ``torch.where`` select where its
own condition held, so a failed problem's NaN factor never reaches a live
one.  The rho refactor runs on the problems that adopted a new rho alone.
:func:`qp_solve` on one problem is this loop on a batch of one;
``qp_solve_batch(impl="vmap")`` is the same loop on the batch.

Each ADMM iteration is one matvec with the fused operator W of the
``schur_cholesky`` backend (:mod:`sqp_solver_tpu_torch.ops.linear_solver`)
and elementwise updates with over-relaxation and box projection.  As in
the JAX package, the chunks are plain tensor code, not a kernel; polish
goes through :func:`~sqp_solver_tpu_torch.qp.polish.polish_qp`, which
takes the polish-KKT kernel (K2) for CUDA tensors.

Every product with P and A goes through the operand helpers of the
linear solvers, so a :class:`~sqp_solver_tpu_torch.ops.block_sparse.BlockSparse`
P or A (arbitrary sparsity, its tiles with the batch axis) runs the same
loop on the matrix-free ``cg`` backend, without scaling or polish, whose
epilogues need dense operands.
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.ops.block_sparse import BlockSparse
from sqp_solver_tpu_torch.ops.linear_solver import _mv, _rmv, get_linear_solver
from sqp_solver_tpu_torch.qp.classify import RHO_MAX, RHO_MIN, constr_type_init, rho_vec_from_type
from sqp_solver_tpu_torch.qp.types import (
    QPInfo,
    QPResult,
    QPSettings,
    QPState,
    QPStatus,
    QuadraticProblem,
)
from sqp_solver_tpu_torch.utils.host import any_live
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["qp_solve", "qp_solve_masked"]


def _linf(v):
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(dim=-1)


def _select(mask, new, old):
    """``new`` where ``mask`` (B,) holds, else ``old``; tensors, dicts of
    them, or None."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: _select(mask, new[k], old[k]) for k in new}
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


def qp_solve(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    state: Optional[QPState] = None,
) -> QPResult:
    """Solve ``min 0.5 x'Px + q'x  s.t.  l <= Ax <= u``.

    One problem (P (n, n), q (n,), A (m, n), l and u (m,); ``state`` with
    x (n,), z and y (m,)) returns a result without the batch axis, as the
    JAX ``qp_solve`` does; a batch-first problem runs as a batch
    (:func:`qp_solve_masked`).  ``state`` warm-starts the iterates.  The
    solve runs on the device of the problem's tensors.  P and A may be
    BlockSparse (module docstring)."""
    if qp.q.dim() == 2:
        return qp_solve_masked(qp, settings, state)

    def lift(v):
        return v.with_data(v.data.unsqueeze(0)) if isinstance(v, BlockSparse) else v.unsqueeze(0)

    one = QuadraticProblem(*(lift(v) for v in (qp.P, qp.q, qp.A, qp.l, qp.u)))
    st = None if state is None else QPState(*(v.unsqueeze(0) for v in (state.x, state.z,
                                                                       state.y)))
    res = qp_solve_masked(one, settings, st)
    info = QPInfo(*(getattr(res.info, k)[0] for k in (
        "status", "iter", "rho_updates", "rho_estimate", "res_prim", "res_dual")))
    return QPResult(x=res.x[0], y=res.y[0], z=res.z[0], info=info)


@pin_precision
def qp_solve_masked(
    qp: QuadraticProblem,
    settings: QPSettings = QPSettings(),
    state: Optional[QPState] = None,
    active: Optional[torch.Tensor] = None,
) -> QPResult:
    """The per-problem tier on a batch-first problem: each problem's
    iterates, iteration and rho-update counts, status and certificates are
    those of a solve of that problem alone.  ``active`` (B,) bool, if
    given, leaves the other problems untouched (the SQP tier's finished
    problems): their result is the warm start, with no meaning."""
    settings.validate()
    if isinstance(qp.P, BlockSparse) or isinstance(qp.A, BlockSparse):
        # the BlockSparse gate (JAX qp/admm.py:101-120)
        if settings.linear_solver != "cg":
            raise ValueError(
                "BlockSparse problems require linear_solver='cg' (the matrix-free "
                "backend); factorizing backends need dense operands, got "
                f"{settings.linear_solver!r}"
            )
        for gate, name in ((settings.scaling > 0, "scaling"), (settings.polish, "polish")):
            if gate:
                raise ValueError(
                    f"BlockSparse problems do not support settings.{name} "
                    "(dense-operand epilogue)"
                )
    if settings.scaling > 0:
        from sqp_solver_tpu_torch.qp.scaling import solve_with_scaling

        return solve_with_scaling(lambda p, s, st: qp_solve_masked(p, s, st, active),
                                  qp, settings, state)
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    dtype, dev = q.dtype, q.device
    B, n = q.shape
    m = A.shape[-2]

    solver = get_linear_solver(settings.linear_solver, settings.block_size,
                               settings.arrow_width)
    sigma = float(settings.sigma)
    alpha = float(settings.alpha)
    eps_abs, eps_rel = float(settings.eps_abs), float(settings.eps_rel)
    tiny = torch.finfo(dtype).eps  # DIV_BY_ZERO_REGUL

    ctype = constr_type_init(l, u)
    rho_vec0 = rho_vec_from_type(ctype, settings.rho, dtype)
    if state is None:
        state = QPState.zeros(B, n, m, dtype=dtype, device=dev)

    # chunk length and rho-epoch length; the epoch is rounded up to a
    # multiple of the chunk, since iterations advance in steps of `seg`
    interval = settings.adaptive_rho_interval if settings.adaptive_rho else settings.max_iter
    check = settings.check_termination
    seg = check if check > 0 else min(interval, settings.max_iter)
    interval = -(-interval // seg) * seg
    use_aa = settings.acceleration == "anderson"
    m_aa = settings.anderson_memory

    def admm_chunk(factor, rho_vec, x, z, y):
        rho_inv = 1.0 / rho_vec
        for _ in range(seg):
            rhs1 = sigma * x - q
            rhs2 = z - rho_inv * y
            x_t, z_t = solver.solve_xz(factor, P, A, sigma, rho_vec, rhs1, rhs2,
                                       settings.refine_steps)
            x_n = alpha * x_t + (1.0 - alpha) * x
            z_pre = alpha * z_t + (1.0 - alpha) * z
            z_n = torch.clamp(z_pre + rho_inv * y, min=l, max=u)  # box projection
            y = y + rho_vec * (z_pre - z_n)
            x, z = x_n, z_n
        return x, z, y

    def update_state(x, z, y):
        """Residuals and norm caches (reference src/qp.cpp:317-331)."""
        Ax = _mv(A, x)
        Px = _mv(P, x)
        ATy = _rmv(A, y)
        max_Ax_z = torch.maximum(_linf(Ax), _linf(z))
        max_Px_ATy_q = torch.maximum(_linf(Px), torch.maximum(_linf(ATy), _linf(q)))
        return _linf(Ax - z), _linf(Px + q + ATy), max_Ax_z, max_Px_ATy_q

    def converged(rp, rd, mz, mq):
        return (rp <= eps_abs + eps_rel * mz) & (rd <= eps_abs + eps_rel * mq)

    def combined(rp, rd, mz, mq):
        return rp / (mz + tiny) + rd / (mq + tiny)

    def anderson_step(c, x, z, y):
        """Safeguarded type-II Anderson acceleration of the chunk map: the
        extrapolated candidate, its z projected back onto [l, u], is taken
        where its combined residual beats the plain chunk output and it
        does not undo termination (JAX qp/admm.py:199-245)."""
        from sqp_solver_tpu_torch.qp.anderson import anderson_extrapolate

        u_aa, pairs, aa_new = anderson_extrapolate(
            c["aa"], torch.cat([c["x"], c["z"], c["y"]], dim=-1),
            torch.cat([x, z, y], dim=-1), m_aa)
        x_a = u_aa[:, :n]
        z_a = torch.clamp(u_aa[:, n:n + m], min=l, max=u)
        y_a = u_aa[:, n + m:]
        st_p = update_state(x, z, y)
        st_a = update_state(x_a, z_a, y_a)
        comb_a = combined(*st_a)
        accept = ((pairs > 0) & torch.isfinite(comb_a) & (comb_a < combined(*st_p))
                  & (converged(*st_a) | ~converged(*st_p)))
        sel = lambda a, p: _select(accept, a, p)  # noqa: E731
        stats = tuple(sel(a, p) for a, p in zip(st_a, st_p))
        return sel(x_a, x), sel(z_a, z), sel(y_a, y), stats, aa_new

    def inner_body(c: dict, mask) -> dict:
        """One chunk, committed where ``mask`` holds."""
        x, z, y = admm_chunk(c["factor"], c["rho_vec"], c["x"], c["z"], c["y"])
        new = dict(c)
        stats = None
        if use_aa:
            x, z, y, stats, new["aa"] = anderson_step(c, x, z, y)
        it = c["iter"] + seg
        if check > 0 and settings.check_infeasibility:
            # OSQP section 3.4 on the chunk's deltas
            from sqp_solver_tpu_torch.qp.infeasibility import infeasibility_certificates

            prim, dual = infeasibility_certificates(P, A, q, l, u, x - c["x"], y - c["y"],
                                                    settings.eps_pinf, settings.eps_dinf)
            cert = torch.where(prim, 1, torch.where(dual, 2, 0)).to(torch.int32)
            new["infeas"] = torch.where(c["infeas"] > 0, c["infeas"], cert)
        if check > 0:
            if stats is None:
                stats = update_state(x, z, y)
            done = converged(*stats)
            if settings.check_comp_slack:
                # z is the projected iterate: clamped rows sit exactly at the
                # bound, so the at-bound test can be razor thin
                btol = 64.0 * torch.finfo(dtype).eps
                at_l = z <= l + btol * (1.0 + l.abs())
                at_u = z >= u - btol * (1.0 + u.abs())
                zero = torch.zeros((), dtype=dtype, device=dev)
                dsv = _linf(torch.where(~at_u, torch.clamp_min(y, 0.0), zero)
                            + torch.where(~at_l, torch.clamp_min(-y, 0.0), zero))
                done = done & (dsv <= eps_abs + eps_rel * _linf(y))
            if settings.verbose:
                obj = 0.5 * (x * _mv(P, x)).sum(-1) + (q * x).sum(-1)
                for i in mask.nonzero().flatten().tolist():
                    print(f"{int(it[i]):4d}  {float(obj[i]):.2e}  {float(stats[0][i]):.2e}  "
                          f"{float(stats[1][i]):.2e}")
            new.update(res_prim=stats[0], res_dual=stats[1], max_Ax_z=stats[2],
                       max_Px_ATy_q=stats[3], done=done)
        new.update(x=x, z=z, y=y, iter=it)
        return _select(mask, new, c)

    def outer_cond(c):
        return ~c["done"] & ~c["failed"] & (c["infeas"] == 0) & (c["iter"] < settings.max_iter)

    def inner_cond(c):
        return outer_cond(c) & (c["iter"] % interval != 0)

    # setup factorization (reference src/qp.cpp:37-43); the loop refactors
    # only on rho updates
    factor0 = solver.factor(P, A, sigma, rho_vec0)

    def zeros(dt=dtype):
        return torch.zeros(B, dtype=dt, device=dev)

    c = dict(
        x=state.x, z=state.z, y=state.y,
        rho=torch.full((B,), settings.rho, dtype=dtype, device=dev), rho_vec=rho_vec0,
        factor=factor0, need_refactor=zeros(torch.bool), iter=zeros(torch.int32),
        done=zeros(torch.bool), failed=solver.is_failure(factor0),
        res_prim=zeros(), res_dual=zeros(), max_Ax_z=zeros(), max_Px_ATy_q=zeros(),
        # before any adaptive evaluation the best estimate is the current rho
        rho_estimate=torch.full((B,), settings.rho, dtype=dtype, device=dev),
        # the reference counts the setup rho update too (src/qp.cpp:34)
        rho_updates=torch.ones(B, dtype=torch.int32, device=dev),
        infeas=zeros(torch.int32), aa=None,
    )
    if use_aa:
        from sqp_solver_tpu_torch.qp.anderson import anderson_init

        c["aa"] = anderson_init((B,), m_aa, n + 2 * m, dtype, device=dev)

    while True:
        oa = outer_cond(c) if active is None else outer_cond(c) & active
        if not any_live(oa):
            break
        # refactor the problems whose rho changed, those alone
        need = oa & c["need_refactor"]
        idx = need.nonzero().flatten()
        if idx.numel():
            sub = solver.factor(P[idx], A[idx], sigma, c["rho_vec"][idx])
            c["factor"] = {k: v.index_copy(0, idx, sub[k]) for k, v in c["factor"].items()}
            c["failed"] = c["failed"].index_copy(0, idx, c["failed"][idx]
                                                 | solver.is_failure(sub))
        c["need_refactor"] = c["need_refactor"] & ~oa

        # one rho epoch: the first chunk unconditionally unless the factor
        # failed (iter % interval == 0 at the epoch's start), then chunks
        # until done, the epoch's end or max_iter
        c = inner_body(c, oa & ~c["failed"])
        while True:
            live = oa & inner_cond(c)
            if not any_live(live):
                break
            c = inner_body(c, live)

        if settings.adaptive_rho:
            if check == 0:
                stats = update_state(c["x"], c["z"], c["y"])
                for k, v in zip(("res_prim", "res_dual", "max_Ax_z", "max_Px_ATy_q"), stats):
                    c[k] = torch.where(oa, v, c[k])
            # rho * sqrt(normalized primal / dual residual) (reference
            # src/qp.cpp:334-341), clamped to [RHO_MIN, RHO_MAX]
            rp = c["res_prim"] / (c["max_Ax_z"] + tiny)
            rd = c["res_dual"] / (c["max_Px_ATy_q"] + tiny)
            new_rho = torch.clamp(c["rho"] * torch.sqrt(rp / (rd + tiny)), RHO_MIN, RHO_MAX)
            tol = settings.adaptive_rho_tolerance
            changed = (new_rho < c["rho"] / tol) | (new_rho > c["rho"] * tol)
            do_update = changed & oa & outer_cond(c)
            c["rho"] = torch.where(do_update, new_rho, c["rho"])
            c["rho_vec"] = torch.where(
                do_update.unsqueeze(-1),
                rho_vec_from_type(ctype, new_rho.unsqueeze(-1), dtype), c["rho_vec"])
            c["need_refactor"] = c["need_refactor"] | do_update
            c["rho_estimate"] = torch.where(oa, new_rho, c["rho_estimate"])
            c["rho_updates"] = c["rho_updates"] + do_update.to(torch.int32)
            if use_aa:
                # the chunk map changes with rho: stale pairs would
                # extrapolate through another fixed point
                aa = c["aa"]
                c["aa"] = dict(aa, prev_ok=aa["prev_ok"] & ~do_update,
                               pairs=torch.where(do_update, 0, aa["pairs"]))

    status = torch.where(
        c["failed"], int(QPStatus.NUMERICAL_ISSUES),
        torch.where(c["done"], int(QPStatus.SOLVED),
                    torch.where(c["infeas"] == 1, int(QPStatus.PRIMAL_INFEASIBLE),
                                torch.where(c["infeas"] == 2, int(QPStatus.DUAL_INFEASIBLE),
                                            int(QPStatus.MAX_ITER_EXCEEDED)))),
    ).to(torch.int32)
    info = QPInfo(
        status=status,
        # iterations run in chunks of `seg`, so the count can overshoot
        # max_iter by up to seg - 1; report the reference's cap
        iter=torch.clamp_max(c["iter"], settings.max_iter),
        rho_updates=c["rho_updates"], rho_estimate=c["rho_estimate"],
        res_prim=c["res_prim"], res_dual=c["res_dual"],
    )
    result = QPResult(x=c["x"], y=c["y"], z=c["z"], info=info)
    if settings.polish:
        from sqp_solver_tpu_torch.qp.polish import polish_qp

        result = polish_qp(qp, result, settings)
    return result
