"""The port's four kernels (twin of ``sqp_solver_tpu/ops/qp_kernel.py``):
the SQP-step kernel (K1), the polish-KKT kernel (K2), the whole-QP kernel
(K3) and the SPD-inverse kernel (K4).

Each kernel has three parts here:

* a **plain PyTorch version** (``sqp_step_reference``,
  ``polish_kkt_reference``, ``qp_solve_reference``,
  ``spd_inverse_reference``): batched tensor code that follows the CUDA
  kernel's per-problem algorithm step by step, including the column-loop
  Cholesky with its pivot clamp and fail rule (no library factorization
  decides a flag).  The CPU path and the tests use it;
* the **CUDA kernel** in ``csrc/qp_kernel.cu`` (one thread block per
  problem; K3 one warp per problem where n <= 32 and m <= 64, K4 where
  n <= 32; K1 and K3 with Anderson acceleration a second instantiation,
  built from ``csrc/qp_kernel_aa.cu``), built with nvcc at first use
  (``ops/_build.py``);
* a **wrapper** (``sqp_step_kernel``, ``polish_kkt_kernel``,
  ``qp_solve_kernel``, ``spd_inverse_kernel``) that sends
  CPU tensors to the plain version and CUDA tensors to the kernel.  A
  CUDA call that the kernel cannot take raises; there is no fallback.

Everything is batch-first: ``(B, n, n)`` Hessians, ``(B, m, n)``
Jacobians, ``(B, n)`` / ``(B, m)`` vectors, ``bool (B,)`` masks.

The plain ADMM core ``_admm_core`` takes the JAX core's operator hooks
(:class:`AdmmOps`: P v, M^-1 b from a factor, A v, A' w), dense here
(:func:`dense_ops`) and banded in ``ops/qp_kernel_btd.py``, whose kernel
shares the CUDA core the same way (``csrc/admm_core.cuh``).

Per-problem semantics.  The TPU kernels decide "factor again" and "run
another chunk" once per tile of 128 problems; here every problem decides
for itself.  A problem's own results are the same either way (a tile
refactor recomputes an unchanged factor; frozen problems stay frozen),
except the factorization count (stats ``n_factor``), which the TPU
counted per tile and is therefore lower here.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from sqp_solver_tpu_torch.qp.classify import (
    LOOSE_BOUNDS_THRESH,
    RHO_EQ_FACTOR,
    RHO_MAX,
    RHO_MIN,
    RHO_TOL,
)
from sqp_solver_tpu_torch.qp.types import (
    QPInfo,
    QPResult,
    QPSettings,
    QPState,
    QPStatus,
    QuadraticProblem,
)
from sqp_solver_tpu_torch.sqp.bfgs import bfgs_update

__all__ = [
    "SQPStepOut",
    "PolishOut",
    "QPSolveOut",
    "sqp_step_kernel",
    "sqp_step_reference",
    "polish_kkt_kernel",
    "polish_kkt_reference",
    "qp_solve_kernel",
    "qp_solve_reference",
    "spd_inverse_kernel",
    "spd_inverse_reference",
    "spd_inverse_problems_per_block",
    "spd_inverse_arm_info",
    "SPD_ARMS",
    "AA_GRAM_SMEM_MEMORY",
    "AA_SOLVES",
    "anderson_placement",
    "anderson_placement_card",
]

# Launch counters: each wrapper adds one where it launches its CUDA kernel
# (never on the plain path), so a run can show that it went through them.
sqp_step_launches = 0
polish_kkt_launches = 0
qp_solve_launches = 0
spd_inverse_launches = 0


class SQPStepOut(NamedTuple):
    """Result of one SQP subproblem step, each field batch-first."""

    p: torch.Tensor  # (B, n) QP primal (the step)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m) QP multipliers
    B: torch.Tensor  # (B, n, n) Hessian after BFGS and posdef fallback
    done: torch.Tensor  # bool (B,) ADMM converged
    iter: torch.Tensor  # int32 (B,) ADMM iterations
    res_prim: torch.Tensor  # (B,)
    res_dual: torch.Tensor  # (B,)
    fail: torch.Tensor  # bool (B,) factorization hit a clamped pivot
    rho_updates: torch.Tensor  # int32 (B,)
    rho_estimate: torch.Tensor  # (B,)
    rho_factor: torch.Tensor  # (B,) rho the emitted Minv was factored under
    n_factor: torch.Tensor  # int32 (B,) factorizations of this problem
    minv: Optional[torch.Tensor]  # (B, n, n) with want_minv, else None


class PolishOut(NamedTuple):
    x: torch.Tensor  # (B, n) solution (a step from 0 unless x0 was given)
    nu: torch.Tensor  # (B, m) multipliers on active rows
    fail: torch.Tensor  # bool (B,) clamped pivot
    li: torch.Tensor  # (B, n, n) L^-1 of the Schur preconditioner


class QPSolveOut(NamedTuple):
    """Raw result of one whole-QP solve, each field batch-first (the eight
    stats rows of the TPU kernel, in its order, after the iterates)."""

    x: torch.Tensor  # (B, n)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m)
    done: torch.Tensor  # bool (B,) converged
    iter: torch.Tensor  # int32 (B,) ADMM iterations run
    res_prim: torch.Tensor  # (B,)
    res_dual: torch.Tensor  # (B,)
    fail: torch.Tensor  # bool (B,) factorization hit a clamped pivot
    rho_updates: torch.Tensor  # int32 (B,)
    rho_estimate: torch.Tensor  # (B,)
    infs: torch.Tensor  # int32 (B,) certificate: 0 none, 1 primal, 2 dual


# ---------------------------------------------------------------------------
# plain versions of the shared pieces
# ---------------------------------------------------------------------------


def _mv(M, v):
    """(B, r, c) @ (B, c) -> (B, r)"""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    """(B, r, c)^T @ (B, r) -> (B, c)"""
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


def _linf(v):
    return v.abs().amax(dim=-1)


def _schedule(s: QPSettings):
    """(seg, chunks_per_epoch, n_epochs) exactly as the JAX kernels derive them."""
    seg = s.check_termination if s.check_termination > 0 else s.max_iter
    interval = s.adaptive_rho_interval if s.adaptive_rho else s.max_iter
    chunks_per_epoch = max(1, -(-min(interval, s.max_iter) // seg))
    n_epochs = max(1, -(-s.max_iter // (chunks_per_epoch * seg)))
    return seg, chunks_per_epoch, n_epochs


def _rho_from(rho, loose, equality):
    """Per-row rho (B, m) from the scalar rho (B,) and the row classes."""
    r = rho.unsqueeze(-1)
    return torch.where(loose, RHO_MIN, torch.where(equality, RHO_EQ_FACTOR * r, r))


def _schur_matrix(P, A, w, sigma):
    """M = P + sigma I + A' diag(w) A (twin of ``_factor_schur_refs``'s build)."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    return P + sigma * eye + torch.matmul(A.mT, A * w.unsqueeze(-1))


def _cholesky_clamped(M):
    """Lower Cholesky by columns with the TPU kernel's pivot rule: a pivot
    d <= 0 or NaN sets ``fail`` and is clamped to max(d, 1e-30)."""
    B, n, _ = M.shape
    W = M.clone()
    L = torch.zeros_like(M)
    fail = torch.zeros(B, dtype=torch.bool, device=M.device)
    for j in range(n):
        d = W[:, j, j]
        fail = fail | (d <= 0) | torch.isnan(d)
        dc = torch.clamp_min(d, 1e-30)  # NaN stays NaN, as jnp.maximum
        col = W[:, j + 1:, j] * torch.rsqrt(dc).unsqueeze(-1)
        L[:, j, j] = torch.sqrt(dc)
        L[:, j + 1:, j] = col
        W[:, j + 1:, j + 1:] -= col.unsqueeze(-1) * col.unsqueeze(-2)
    return L, fail


def _tri_inv(L):
    """L^-1 of a lower-triangular batch by forward substitution, dividing by
    max(L_ii, 1e-30) as the TPU kernel does."""
    B, n, _ = L.shape
    Li = torch.zeros_like(L)
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    for i in range(n):
        acc = torch.matmul(L[:, i:i + 1, :i], Li[:, :i, :]).squeeze(-2)
        Li[:, i, :] = (eye[i] - acc) / torch.clamp_min(L[:, i, i], 1e-30).unsqueeze(-1)
    return Li


def _chol_inv_ltl(M, ltl=True):
    """(Minv = L^-T L^-1, fail) or, with ``ltl=False``, (L^-1, fail)
    (twin of ``_chol_inv_ltl``)."""
    L, fail = _cholesky_clamped(M)
    Li = _tri_inv(L)
    if not ltl:
        return Li, fail
    return torch.matmul(Li.mT, Li), fail


def _chol_inv_blocked(M, nb: int = 32, ltl: bool = True):
    """(Minv = L^-T L^-1, fail) or, with ``ltl=False``, (L^-1, fail) in the
    order of the CUDA factor of K1, K2 and K4's blocked layout
    (``csrc/dense_factor.cuh``, whose in-place steps sum every element as
    the two-buffer ones do):
    Cholesky in panels of ``nb`` columns (the diagonal block by columns, the
    rows below it, then the trailing update), with the pivot rule of
    :func:`_cholesky_clamped`; L^-1 by blocks, the diagonal ones by forward
    substitution and Li_ij = -Li_ii sum_{k=j}^{i-1} L_ik Li_kj by block
    distance.  The plain K1 / K2 keep :func:`_chol_inv_ltl`, the oracle they
    share with K3 / K4; this twin holds the blocked order against it."""
    B, n, _ = M.shape
    W = M.clone()
    L = torch.zeros_like(M)
    fail = torch.zeros(B, dtype=torch.bool, device=M.device)
    for c0 in range(0, n, nb):
        c1 = min(c0 + nb, n)
        rs = []
        for j in range(c0, c1):  # the diagonal block, column by column
            d = W[:, j, j]
            fail = fail | (d <= 0) | torch.isnan(d)
            dc = torch.clamp_min(d, 1e-30)
            rs.append(torch.rsqrt(dc))
            col = W[:, j + 1:c1, j] * rs[-1].unsqueeze(-1)
            L[:, j, j] = torch.sqrt(dc)
            L[:, j + 1:c1, j] = col
            W[:, j + 1:c1, j + 1:c1] -= col.unsqueeze(-1) * col.unsqueeze(-2)
        if c1 == n:
            break
        X = W[:, c1:, c0:c1].clone()  # the rows below, column by column
        for j in range(c1 - c0):
            X[:, :, j] = X[:, :, j] * rs[j].unsqueeze(-1)
            X[:, :, j + 1:] -= X[:, :, j:j + 1] * L[:, c0 + j + 1:c1, c0 + j].unsqueeze(-2)
        L[:, c1:, c0:c1] = X
        W[:, c1:, c1:] -= torch.matmul(X, X.mT)
    Li = torch.zeros_like(M)
    blocks = [(o, min(o + nb, n)) for o in range(0, n, nb)]
    for o, e in blocks:
        Li[:, o:e, o:e] = _tri_inv(L[:, o:e, o:e])
    for d in range(1, len(blocks)):
        for J in range(len(blocks) - d):
            (oj, ej), (oi, ei) = blocks[J], blocks[J + d]
            T = torch.matmul(L[:, oi:ei, oj:oi], Li[:, oj:oi, oj:ej])
            Li[:, oi:ei, oj:ej] = -torch.matmul(Li[:, oi:ei, oi:ei], T)
    if not ltl:
        return Li, fail
    return torch.matmul(Li.mT, Li), fail


def _factor(P, A, rho_vec, sigma):
    """Minv and fail of M = P + sigma I + A' diag(rho) A."""
    return _chol_inv_ltl(_schur_matrix(P, A, rho_vec, sigma))


def _admm_stats(ops, q, x, z, y):
    Ax = ops.amv(x)
    Px = ops.pmv(x)
    ATy = ops.atmv(y)
    res_prim = _linf(Ax - z)
    res_dual = _linf(Px + q + ATy)
    max_Ax_z = torch.maximum(_linf(Ax), _linf(z))
    max_Px_ATy_q = torch.maximum(_linf(Px), torch.maximum(_linf(ATy), _linf(q)))
    return res_prim, res_dual, max_Ax_z, max_Px_ATy_q


def _admm_iter(ops, factor, q, l, u, x, z, y, rv, sigma, alpha):
    rho_inv = 1.0 / rv
    rhs2 = rv * z - y
    b = sigma * x - q + ops.atmv(rhs2)
    xt = ops.apply_minv(factor, b)
    zt = ops.amv(xt)
    xn = alpha * xt + (1.0 - alpha) * x
    z_pre = alpha * zt + (1.0 - alpha) * z
    zn = torch.clamp(z_pre + rho_inv * y, min=l, max=u)
    yn = y + rv * (z_pre - zn)
    return xn, zn, yn


def _certificates(ops, q, dx, dy, lo_l, lo_u, l_eff, u_eff, eps_pinf, eps_dinf):
    """Infeasibility certificate code per problem from a chunk's iterate
    deltas (OSQP section 3.4; twin of ``_admm_core.certificates``):
    1 = primal infeasible (dy), 2 = dual infeasible (dx), 0 = none."""
    norm_dy = _linf(dy)
    sup = (u_eff * torch.clamp_min(dy, 0.0) + l_eff * torch.clamp_max(dy, 0.0)).sum(-1)
    prim = (
        (norm_dy > 0.0)
        & (_linf(ops.atmv(dy)) <= eps_pinf * norm_dy)
        & (sup <= -eps_pinf * norm_dy)
    )
    norm_dx = _linf(dx)
    Adx = ops.amv(dx)
    tol = (eps_dinf * norm_dx).unsqueeze(-1)
    ray_ok = ((lo_u | (Adx <= tol)) & (lo_l | (Adx >= -tol))).all(-1)
    dual = (
        (norm_dx > 0.0)
        & (_linf(ops.pmv(dx)) <= eps_dinf * norm_dx)
        & ((q * dx).sum(-1) <= -eps_dinf * norm_dx)
        & ray_ok
    )
    zero = torch.zeros_like(norm_dx, dtype=torch.int32)
    return torch.where(prim, 1, torch.where(dual, 2, zero)).to(torch.int32)


class AdmmOps(NamedTuple):
    """The operator hooks of :func:`_admm_core` (twin of the JAX core's
    ``pmv`` / ``apply_minv`` / ``amv`` / ``atmv``): P v, M^-1 b from a
    factor, A v and A' w, each batch-first."""

    pmv: Callable
    apply_minv: Callable  # (factor, b) -> M^-1 b
    amv: Callable
    atmv: Callable


def dense_ops(P, A) -> AdmmOps:
    """The dense hooks: P and A as (B, n, n) / (B, m, n) matrices and the
    factor an explicit Minv (B, n, n)."""
    return AdmmOps(pmv=lambda v: _mv(P, v), apply_minv=_mv,
                   amv=lambda v: _mv(A, v), atmv=lambda w: _mtv(A, w))


def _select(mask, new, old):
    """torch.where over the batch axis for a factor (a tensor or a tuple
    of tensors, each batch-first)."""
    if isinstance(new, tuple):
        return tuple(_select(mask, a, b) for a, b in zip(new, old))
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def _admm_core(ops, q, l, u, x, z, y, done, failv, rho, Minv, factor_fn, *,
               sigma, alpha, eps_abs, eps_rel, n_epochs, chunks_per_epoch, seg,
               adaptive_rho, adaptive_rho_tolerance, pending=None,
               check_infeas=False, eps_pinf=1e-4, eps_dinf=1e-4,
               use_aa=False, aa_mem=4):
    """Twin of ``_admm_core``: rho epochs with adoption at factor time,
    chunks of ``seg`` iterations with per-problem early exit, adaptive rho,
    the termination residuals, with ``check_infeas`` the infeasibility
    certificates and with ``use_aa`` safeguarded type-II Anderson
    acceleration of the chunk map.  ``ops`` are the operator hooks
    (:func:`dense_ops` for a dense P, A and Minv); ``Minv`` is the entry
    factor in whatever form ``ops.apply_minv`` reads (a tensor or a tuple
    of tensors), and ``factor_fn(rho_vec) -> (factor, fail)`` builds a new
    one.  ``pending`` (bool (B,)) makes the first epoch adopt ``rho`` and
    factor (the whole-QP solve enters so).  A certified problem commits
    its chunk and is frozen from then on.  Returns the updated state as a
    dict (``infs``: int32 certificate code, ``minv``: the final factor).

    Anderson, per problem, on the iterate packed as (x, z, y) (D2 = n + 2m,
    not the fused tier's (s, y) packing): ``aa_mem`` difference pairs in
    ring buffers, the newest at the end; the Levenberg-regularized k x k
    normal equations solved by Gauss-Jordan; the candidate's z clipped to
    [l, u]; each chunk evaluates the residuals of the plain result and of
    the candidate and takes the candidate where it has pairs, a finite
    combined residual rp / (mz + 1e-30) + rd / (mq + 1e-30) below the plain
    one, and does not undo termination.  The certificates take the accepted
    deltas.  A pending rho empties the ring; every entry starts with a
    fresh one.  The ring is updated on every problem, as on the TPU; a
    frozen problem never reads it."""
    B = q.shape[0]
    dev = q.device
    n, m = q.shape[-1], l.shape[-1]
    if use_aa:
        from sqp_solver_tpu_torch.qp.anderson import (
            anderson_extrapolate,
            anderson_init,
            gauss_jordan,
        )

        aa = anderson_init((B,), aa_mem, n + 2 * m, q.dtype, device=dev)

        def comb(st):
            return st[0] / (st[2] + 1e-30) + st[1] / (st[3] + 1e-30)

        def term(st):
            return (st[0] <= eps_abs + eps_rel * st[2]) & (st[1] <= eps_abs + eps_rel * st[3])
    loose = (l < -LOOSE_BOUNDS_THRESH) & (u > LOOSE_BOUNDS_THRESH)
    equality = (u - l) < RHO_TOL
    itc = torch.zeros(B, dtype=torch.int32, device=dev)
    # the reference counts the setup rho update (src/qp.cpp:34)
    rho_upd = torch.ones(B, dtype=torch.int32, device=dev)
    rho_est = rho.clone()
    rp, rd, mz, mq = (torch.zeros_like(rho) for _ in range(4))
    if pending is None:
        pending = torch.zeros(B, dtype=torch.bool, device=dev)
    nfact = torch.zeros(B, dtype=torch.int32, device=dev)
    infs = torch.zeros(B, dtype=torch.int32, device=dev)
    if check_infeas:
        lo_l = l < -LOOSE_BOUNDS_THRESH
        lo_u = u > LOOSE_BOUNDS_THRESH
        u_eff = torch.where(lo_u, 1e20, u)
        l_eff = torch.where(lo_l, -1e20, l)
    for _ in range(n_epochs):
        active = ~done & ~failv & (infs == 0)
        if not bool(active.any()):
            break
        # adopt a pending rho only together with its factorization, so
        # (Minv, rho) stay paired for factor reuse.  The TPU adopts by the
        # arithmetic select rho + adopt (rho_est - rho), so a NaN rho_est
        # (NaN residuals) poisons rho; such a problem refactors here and the
        # factorization reports the fail
        adopt = pending & ~done & ~failv
        rho = torch.where(adopt | torch.isnan(rho_est), rho_est, rho)
        refactor = (adopt | torch.isnan(rho)) & ~done & ~failv
        if bool(refactor.any()):
            Minv_new, f = factor_fn(_rho_from(rho, loose, equality))
            Minv = _select(refactor, Minv_new, Minv)
            failv = failv | (f & refactor)
            nfact = nfact + refactor.to(torch.int32)
        rv = _rho_from(rho, loose, equality)
        for _ in range(chunks_per_epoch):
            act = ~done & ~failv & (infs == 0)
            if not bool(act.any()):
                break
            xn, zn, yn = x, z, y
            for _ in range(seg):
                xn, zn, yn = _admm_iter(ops, Minv, q, l, u, xn, zn, yn, rv, sigma, alpha)
            x_pre, y_pre = x, y
            a1 = act.unsqueeze(-1)
            if use_aa:
                u_aa, pairs, aa = anderson_extrapolate(
                    aa, torch.cat([x, z, y], dim=-1), torch.cat([xn, zn, yn], dim=-1),
                    aa_mem, solve=gauss_jordan)
                x_a = u_aa[:, :n]
                z_a = torch.clamp(u_aa[:, n:n + m], min=l, max=u)  # keep the box invariant
                y_a = u_aa[:, n + m:]
                sp = _admm_stats(ops, q, xn, zn, yn)
                sa = _admm_stats(ops, q, x_a, z_a, y_a)
                comb_a = comb(sa)
                accept = ((pairs > 0) & torch.isfinite(comb_a) & (comb_a < comb(sp))
                          & (term(sa) | ~term(sp)))
                ac1 = accept.unsqueeze(-1)
                xn = torch.where(ac1, x_a, xn)
                zn = torch.where(ac1, z_a, zn)
                yn = torch.where(ac1, y_a, yn)
                stats = tuple(torch.where(accept, a, p) for a, p in zip(sa, sp))
            x = torch.where(a1, xn, x)
            z = torch.where(a1, zn, z)
            y = torch.where(a1, yn, y)
            if not use_aa:
                stats = _admm_stats(ops, q, x, z, y)
            res_prim, res_dual, max_Ax_z, max_Px_ATy_q = stats
            if check_infeas:
                cert = _certificates(ops, q, xn - x_pre, yn - y_pre, lo_l, lo_u,
                                     l_eff, u_eff, eps_pinf, eps_dinf)
                infs = torch.where(act & (cert > 0), cert, infs)
            conv = (res_prim <= eps_abs + eps_rel * max_Ax_z) & (
                res_dual <= eps_abs + eps_rel * max_Px_ATy_q
            )
            itc = torch.where(act, itc + seg, itc)
            rp = torch.where(act, res_prim, rp)
            rd = torch.where(act, res_dual, rd)
            mz = torch.where(act, max_Ax_z, mz)
            mq = torch.where(act, max_Px_ATy_q, mq)
            done = done | (act & conv)
        if adaptive_rho:
            tinyv = 1e-30
            nrp = rp / (mz + tinyv)
            nrd = rd / (mq + tinyv)
            new_rho = torch.clamp(rho * torch.sqrt(nrp / (nrd + tinyv)), RHO_MIN, RHO_MAX)
            act = ~done & ~failv & (infs == 0)
            changed = (
                (new_rho < rho / adaptive_rho_tolerance)
                | (new_rho > rho * adaptive_rho_tolerance)
            ) & act
            rho_upd = rho_upd + changed.to(torch.int32)
            rho_est = torch.where(act, new_rho, rho_est)
            pending = changed
            if use_aa:
                # the chunk map changes with rho: stale pairs would
                # extrapolate through another fixed point
                aa = dict(aa, prev_ok=aa["prev_ok"] & ~pending,
                          pairs=torch.where(pending, 0, aa["pairs"]))
    return dict(x=x, z=z, y=y, done=done, fail=failv, iter=itc, rho=rho,
                rho_updates=rho_upd, rho_estimate=rho_est, res_prim=rp,
                res_dual=rd, n_factor=nfact, minv=Minv, infs=infs)


# ---------------------------------------------------------------------------
# K1: the SQP-step kernel
# ---------------------------------------------------------------------------


def sqp_step_reference(
    B, J, g, l, u, s, dgl, reset, upd, active, x, z, y,
    settings: QPSettings,
    do_bfgs: bool = True,
    rho_in: Optional[torch.Tensor] = None,
    minv_in: Optional[torch.Tensor] = None,
    want_minv: bool = False,
) -> SQPStepOut:
    """Plain version of the SQP-step kernel: damped BFGS, posdef fallback
    (factor; on a failed pivot B := I and refactor, at most 2 attempts),
    then the warm-started ADMM solve of

        min 0.5 p'Bp + g'p   s.t.   l <= J p <= u.

    ``minv_in`` reuses a previous solve's factor (same B, J; new bounds),
    with ``rho_in`` its ``rho_factor``; ``want_minv`` emits the final
    factor (zeros for a problem that never factored)."""
    dtype = g.dtype
    batch, n = g.shape
    sigma = float(settings.sigma)
    rho0 = float(settings.rho)
    seg, cpe, n_epochs = _schedule(settings)
    Bn = bfgs_update(B, s, dgl, reset, upd) if do_bfgs else B
    loose = (l < -LOOSE_BOUNDS_THRESH) & (u > LOOSE_BOUNDS_THRESH)
    equality = (u - l) < RHO_TOL
    nfact0 = torch.zeros(batch, dtype=torch.int32, device=g.device)
    rho = torch.full((batch,), rho0, dtype=dtype, device=g.device)
    if minv_in is not None:
        Minv = minv_in
        if rho_in is not None:
            rho = torch.where(rho_in > 0, rho_in, rho)
        failv = torch.zeros(batch, dtype=torch.bool, device=g.device)
    else:
        rv0 = _rho_from(rho, loose, equality)
        Minv = torch.zeros_like(B)
        f = torch.zeros(batch, dtype=torch.bool, device=g.device)
        if bool(active.any()):
            Minv_a, f_a = _factor(Bn, J, rv0, sigma)
            Minv = torch.where(active[:, None, None], Minv_a, Minv)
            nfact0 = nfact0 + active.to(torch.int32)
            f = f_a & active
            if bool(f.any()):
                eye = torch.eye(n, dtype=dtype, device=g.device)
                Bn = torch.where(f[:, None, None], eye, Bn)
                Minv_b, f_b = _factor(Bn, J, rv0, sigma)
                Minv = torch.where(f[:, None, None], Minv_b, Minv)
                nfact0 = nfact0 + f.to(torch.int32)
                f = torch.where(f, f_b, f)
        failv = f & active
    out = _admm_core(
        dense_ops(Bn, J), g, l, u, x, z, y, ~active, failv, rho, Minv,
        lambda rv: _factor(Bn, J, rv, sigma),
        sigma=sigma, alpha=float(settings.alpha),
        eps_abs=float(settings.eps_abs), eps_rel=float(settings.eps_rel),
        n_epochs=n_epochs, chunks_per_epoch=cpe, seg=seg,
        adaptive_rho=bool(settings.adaptive_rho),
        adaptive_rho_tolerance=float(settings.adaptive_rho_tolerance),
        **_aa_args(settings),
    )
    return SQPStepOut(
        p=out["x"], z=out["z"], y=out["y"], B=Bn, done=out["done"],
        iter=out["iter"], res_prim=out["res_prim"], res_dual=out["res_dual"],
        fail=out["fail"], rho_updates=out["rho_updates"],
        rho_estimate=out["rho_estimate"], rho_factor=out["rho"],
        n_factor=nfact0 + out["n_factor"],
        minv=out["minv"] if want_minv else None,
    )


def _aa_args(settings: QPSettings) -> dict:
    """The Anderson arguments of :func:`_admm_core` from the settings."""
    return dict(use_aa=settings.acceleration == "anderson",
                aa_mem=int(settings.anderson_memory))


def _aa_workspace(lib, settings: QPSettings, slices: int, n: int, m: int, dev):
    """``(aa_mem, workspace)`` for a launch with Anderson: one slice of the
    kernel's state (``admm_core.cuh:aa_floats``) for each of ``slices``
    scopes of n variables and m rows; ``(0, None)`` without it.  Raises a
    ValueError on a memory that is not positive."""
    if settings.acceleration != "anderson":
        return 0, None
    k = int(settings.anderson_memory)
    _check_aa_memory(k)
    floats = int(lib.admm_aa_floats(k, n, m))
    return k, torch.empty((slices * floats,), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# Where the Anderson kernels keep their state (csrc/admm_core.cuh)
# ---------------------------------------------------------------------------

# Up to this ``anderson_memory`` every CUDA launch keeps each scope's Gram
# area in shared memory (admm_core.cuh:kAaGramSmemMemory); past it the rule
# below decides, as it does for the ring.  The kernels, like the plain
# versions, take any memory >= 1.
AA_GRAM_SMEM_MEMORY = 32

# Where K1's and K3's chunk system goes past that (admm_core.cuh:AaSolve,
# by its codes): beside the kept Gram in the Gram area, a solve area a
# scope or a block in shared memory, or the workspace.
AA_SOLVES = ("gram", "scope", "block", "workspace")
_AA_SOLVE_HEAD = 4  # before a block's solve areas: the lock word, and alignment


def _aa_solve_floats(k: int) -> int:
    """Floats of one solve area (admm_core.cuh:aa_solve_floats): the
    k x (k + 1) system by columns, each of the k rows padded to a multiple
    of 8 and 4 more."""
    return (((k + 7) & ~7) + 4) * (k + 1)

# sm_90's shared memory (admm_core.cuh: kMaxSmemBytes, kAaSmemPerSm,
# kAaSmemReserved) and the reduction slots
_MAX_SMEM = 232448
_SMEM_PER_SM = 233472
_SMEM_RESERVED = 1024
_RED_SLOTS = 8 * 32
_QP_WARPS = 2  # K3's problems a block under its warp layout

ANDERSON_KERNELS = ("K1", "K3-block", "K3-warp", "K6", "K7", "wide")


def _check_aa_memory(k: int) -> None:
    if k <= 0:
        raise ValueError(f"anderson_memory = {k}: the CUDA kernels take a memory of 1 or more")


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _smem_blocks(smem_bytes: int) -> int:
    """Blocks an SM that sm_90's shared memory allows at ``smem_bytes`` a
    block (admm_core.cuh:smem_blocks_per_sm)."""
    return _SMEM_PER_SM // (smem_bytes + _SMEM_RESERVED)


def _plan(vec: int, mats) -> tuple:
    """(shared bytes, matrices in shared memory, workspace floats) of
    ``csrc/qp_kernel.cu:plan``: the vectors, then the matrices first-fit in
    their order."""
    smem, held, ws, spill = 4 * vec, 0, 0, False
    for size in mats:
        if not spill and smem + 4 * size <= _MAX_SMEM:
            smem += 4 * size
            held += 1
        else:
            spill = True
            ws += size
    return smem, held, ws


def _qp_warp_floats(n: int, m: int) -> int:
    ld4 = _round4(n) if _round4(n) & 7 else _round4(n) + 4  # stride4
    return 7 * _round4(n) + 7 * _round4(m) + (_round4(m) + n) * ld4


def _btd_fixed_floats(n: int, m: int, bb: int, cs: int) -> int:
    m0 = -(-m // cs)
    ring = 4 * max(n, 16) if cs > 1 else 0
    return 8 * n + 7 * m0 + _RED_SLOTS + ring + 5 * n * bb + 2 * bb * (bb + 1) + 1


def _btd_block_rows(n: int, m: int, bb: int, cs: int, extra: int = 0) -> int:
    spare = _MAX_SMEM // 4 - _btd_fixed_floats(n, m, bb, cs) - extra
    return -1 if spare < 0 else min(spare // (n + 1), -(-m // cs))


def anderson_placement(kernel: str, n: int, m: int, k: int, *, twin_blocks: Optional[int],
                       bb: Optional[int] = None, cluster: Optional[int] = None,
                       wide=None) -> dict:
    """Where an Anderson launch keeps its state (the rule of the kernels'
    launchers: ``csrc/qp_kernel.cu:aa_dense_plan``, ``qp_kernel_btd.cu:
    btd_aa_plan``, ``qp_kernel_btd_wide.cu:wide_aa_plan``), a function
    of the kernel, its shape and the memory k.  Each scope's ring
    (``ring_floats``: the difference pairs and four iterates) is in shared
    memory (``ring``) where the block's shared memory with it and the Gram
    area still holds what the kernel without Anderson holds (its matrices,
    or rows of A) and allows as many blocks an SM as that kernel gets
    (``twin_blocks``: the runtime's occupancy of it on the card, as
    :func:`anderson_placement_card` reports it), else in the device
    workspace; the wide kernel's stays there, since its arrays take shared
    memory first.  The Gram area (``gram_floats``: the kept k x k Gram and
    the k x (k + 1) system) is in shared memory (``gram``) at every k up to
    :data:`AA_GRAM_SMEM_MEMORY` (where it may take the room of a matrix or
    row of A).  Past it the chunk's system (``solve``: one of
    :data:`AA_SOLVES`) leaves the Gram area: K1's and K3's for a solve area
    a problem or a block in shared memory, or the workspace, their Gram
    area always for the workspace (:func:`_aa_dense_placement`); the
    structured kernels' (K6, K7 and the wide kernel, a scope a block) for a
    solve area in shared memory ("scope") or the workspace, each area on
    chip only where it costs the kernel without Anderson nothing (no row of
    A, no array in shared memory, no block an SM): the Gram area (kept
    Gram) and a solve area both where the two together do, else the solve
    area alone, else the Gram area alone where it does, the system then in
    the workspace (:func:`_aa_structured_placement`).  ``solve_floats``: the
    block's solve areas' floats in shared memory.  ``kernel``: "K1",
    "K3-block", "K3-warp", "K6" or "K7" (the structured kernel at internal
    block ``bb`` <= 32 and ``cluster`` blocks a problem) or "wide", for
    which ``wide`` gives the layouts (:func:`qp_kernel_btd.wide_layout`'s
    ``shared`` and ``smem_bytes``, None where refused) where k passes that
    memory, as a callable of the floats reserved (0: the layout without
    Anderson).  Returns ``ring``, ``gram``,
    ``solve``, ``solve_floats``, ``gram_floats``, ``ring_floats``,
    ``twin_blocks``, and but for the wide kernel ``smem_bytes`` and
    ``twin_smem_bytes`` (a block's) and the rows of A (``rows``,
    ``twin_rows``; the structured kernel) or matrices (``mats``,
    ``twin_mats``; K1, K3's block layout) in shared memory with Anderson
    and without.  Raises a ValueError on a memory below 1."""
    _check_aa_memory(k)
    if kernel not in ANDERSON_KERNELS:
        raise ValueError(f"anderson_placement: kernel {kernel!r} not one of {ANDERSON_KERNELS}")
    gram = _round4(k * k + k * (k + 1))
    always = k <= AA_GRAM_SMEM_MEMORY
    rows_of = m if kernel in ("K1", "K3-block", "K3-warp") else -(-m // (cluster or 2))
    ring_floats = (2 * k + 4) * (n + 2 * rows_of)
    out = dict(gram_floats=gram, ring_floats=ring_floats, twin_blocks=twin_blocks)
    if kernel == "wide":
        if always:
            return dict(out, ring=False, gram=True, solve="gram", solve_floats=0)
        if wide is None:
            raise ValueError("anderson_placement: the wide kernel past memory "
                             f"{AA_GRAM_SMEM_MEMORY} needs its layouts (wide)")
        plain = wide(0)

        def keeps(reserve):
            lay = wide(reserve)
            return (lay is not None and plain is not None and lay["shared"] == plain["shared"]
                    and _smem_blocks(lay["smem_bytes"]) >= _smem_blocks(plain["smem_bytes"]))

        return dict(out, ring=False, **_aa_structured_placement(k, gram, None, keeps))
    if kernel in ("K1", "K3-block", "K3-warp"):
        return dict(out, **_aa_dense_placement(kernel, n, m, k, gram, ring_floats, twin_blocks))
    cs = cluster or 1
    if bb is None or bb > 32:
        raise ValueError("anderson_placement: the structured kernel takes an internal block "
                         "of 8 to 32 (bb); wider ones are the wide kernel's")
    fixed = _btd_fixed_floats(n, m, bb, cs)
    twin_rows = _btd_block_rows(n, m, bb, cs)

    def keeps(area):
        with_area = 4 * (fixed + area + twin_rows * (n + 1))
        return (twin_rows >= 0 and _btd_block_rows(n, m, bb, cs, area) == twin_rows
                and with_area <= _MAX_SMEM and _smem_blocks(with_area) >= twin_blocks)

    if always:
        ring = keeps(gram + ring_floats)
        place = dict(gram=True, solve="gram", solve_floats=0)
    else:
        place = _aa_structured_placement(k, gram, ring_floats, keeps)
        ring = place.pop("ring")
    extra = (gram if place["gram"] else 0) + (ring_floats if ring else 0) + place["solve_floats"]
    rows = twin_rows if extra == 0 else _btd_block_rows(n, m, bb, cs, extra)
    return dict(out, ring=ring, **place, smem_bytes=4 * (fixed + rows * (n + 1) + extra),
                twin_smem_bytes=4 * (fixed + twin_rows * (n + 1)), rows=rows, twin_rows=twin_rows)


def _aa_structured_placement(k: int, gram: int, ring_floats: Optional[int], keeps) -> dict:
    """The structured kernels' placement past :data:`AA_GRAM_SMEM_MEMORY`
    (``csrc/qp_kernel_btd.cu:btd_aa_plan``, ``qp_kernel_btd_wide.cu:
    wide_aa_plan``), ``keeps(floats)`` telling whether that many floats more
    in shared memory cost the kernel without Anderson nothing: the Gram
    area (``gram`` floats) and a solve area (:func:`_aa_solve_floats` after
    a head of 4) both on chip where the two together keep it (K6/K7: with
    the ring, ``ring_floats``, too where all three do), else the solve area
    alone ("scope"), else the system in the workspace and the Gram area on
    chip where it alone keeps it.  ``gram``, ``solve``, ``solve_floats``
    and, for K6/K7, ``ring``."""
    s = _AA_SOLVE_HEAD + _aa_solve_floats(k)
    ring = ring_floats is not None and keeps(gram + ring_floats + s)
    both = ring or keeps(gram + s)
    sys_on = both or keeps(s)
    res = dict(gram=both or (not sys_on and keeps(gram)),
               solve="scope" if sys_on else "workspace", solve_floats=s if sys_on else 0)
    if ring_floats is not None:
        res["ring"] = ring
    return res


def _aa_dense_placement(kernel: str, n: int, m: int, k: int, gram: int, ring_floats: int,
                        twin_blocks: int) -> dict:
    """:func:`anderson_placement` of K1 and K3 (``csrc/qp_kernel.cu:
    aa_dense_plan``): up to :data:`AA_GRAM_SMEM_MEMORY` the Gram area in
    shared memory and the ring as for the other kernels; past it both in the
    workspace, and the chunk's system (the
    k x k solve's operand, ``solve``: one of :data:`AA_SOLVES`) goes to a
    solve area of :func:`_aa_solve_floats` a problem in shared memory (after
    a head of 4 floats) where that keeps the twin's matrices and blocks an
    SM, else (K3's warp layout, two problems a block) to one area a block,
    after its head and lock word, where that does, else to such an area wherever shared memory holds it
    beside the twin's matrices (at fewer blocks an SM), else to the
    workspace.  ``solve_floats``: the block's solve areas' floats."""
    warp = kernel == "K3-warp"
    if warp and not (n <= 32 and m <= 64):
        raise ValueError("anderson_placement: K3's warp layout takes n <= 32, m <= 64")
    scopes = _QP_WARPS if warp else 1
    if warp:
        base = _QP_WARPS * _qp_warp_floats(n, m)

        def lay(extra):
            return 4 * (base + extra), 0, 0
    else:
        ld = n + 1
        mats = (n * ld, m * ld, n * ld)
        vec = (9 * n if kernel == "K1" else 7 * n) + 7 * m + _RED_SLOTS

        def lay(extra):
            return _plan(vec + extra, mats)
    twin = lay(0)

    def fits(extra):
        with_extra = lay(extra)
        return with_extra[1] == twin[1] and with_extra[0] <= _MAX_SMEM

    def keeps(extra):
        return fits(extra) and _smem_blocks(lay(extra)[0]) >= twin_blocks

    sa = _aa_solve_floats(k)
    per_scope, per_block = _AA_SOLVE_HEAD + scopes * sa, _AA_SOLVE_HEAD + sa
    on = k <= AA_GRAM_SMEM_MEMORY
    ring = on and keeps(scopes * (gram + ring_floats))
    if on:
        solve = "gram"
    elif keeps(per_scope):
        solve = "scope"
    elif scopes > 1 and keeps(per_block):
        solve = "block"
    elif fits(per_block if scopes > 1 else per_scope):
        solve = "block" if scopes > 1 else "scope"
    else:
        solve = "workspace"
    sys = {"scope": per_scope, "block": per_block}.get(solve, 0)
    smem, mats_on, ws = lay(scopes * ((gram if on else 0) + (ring_floats if ring else 0)) + sys)
    res = dict(ring=ring, gram=on, solve=solve, solve_floats=sys, smem_bytes=smem,
               twin_smem_bytes=twin[0])
    if not warp:
        res.update(mats=mats_on, twin_mats=twin[1], workspace_floats=ws)
    return res


_AA_CODES = {"K1": 1, "K3-block": 2, "K3-warp": 3}


def anderson_placement_card(kernel: str, n: int, m: int, k: int, bb: Optional[int] = None,
                            cluster: Optional[int] = None, device: int = 0, lib=None,
                            nnz: Optional[tuple] = None) -> dict:
    """The placement as the built kernel's launcher decides it on the card
    (``qp_kernel_aa_placement``, ``qp_btd_aa_placement``,
    ``qp_btd_wide_layout_nnz``): the keys of :func:`anderson_placement`
    with the twin's blocks an SM from the runtime, and ``blocks``: the
    Anderson kernel's at its shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; not for the wide
    kernel, whose ``smem_bytes`` and ``workspace_floats`` are those of its
    layout with the Gram area reserved where it is in shared memory, past
    internal block 128 for the nonzeros a block holds, ``nnz``, as
    :func:`qp_kernel_btd.wide_layout` takes them)."""
    lib = lib or _library()
    if kernel == "wide":
        from sqp_solver_tpu_torch.ops.qp_kernel_btd import wide_layout

        lay = wide_layout(n, m, bb, nnz=nnz, anderson=k, lib=lib) if k >= 1 else None
        if lay is None:
            raise ValueError(f"anderson_placement_card: the wide kernel refuses n={n}, m={m}, "
                             f"bb={bb}, k={k}")
        gram = _round4(k * k + k * (k + 1))
        return dict(ring=False, gram=lay["gram_shared"], solve=lay["solve"],
                    solve_floats=lay["solve_floats"], smem_bytes=lay["smem_bytes"],
                    workspace_floats=lay["workspace_floats"], gram_floats=gram,
                    ring_floats=(2 * k + 4) * (n + 2 * lay["rows_per_member"]))
    out = (ctypes.c_longlong * 12)()
    if kernel in _AA_CODES:
        rc = int(lib.qp_kernel_aa_placement(_AA_CODES[kernel], n, m, k, device, out))
        keys = ("ring", "smem_bytes", "twin_smem_bytes", "twin_blocks", "blocks",
                "gram_floats", "ring_floats", "problems_per_block", "workspace_floats", "gram",
                "solve", "solve_floats")
    else:
        rc = int(lib.qp_btd_aa_placement(n, m, bb, cluster, k, device, out))
        keys = ("ring", "smem_bytes", "twin_smem_bytes", "twin_blocks", "blocks",
                "gram_floats", "ring_floats", "rows", "twin_rows", "gram", "solve",
                "solve_floats")
    _raise_on(lib, rc, "anderson_placement_card")
    res = {key: int(v) for key, v in zip(keys, out)}
    res["ring"], res["gram"] = bool(res["ring"]), bool(res["gram"])
    if "solve" in res:
        res["solve"] = AA_SOLVES[res["solve"]]
    return res


def _workspace_floats(lib, kernel: str, n: int, m: int, aa_mem: int) -> int:
    """Workspace floats a problem of K1 or K3's block layout: with Anderson
    those of its launch, whose Gram area may leave a matrix out of shared
    memory (a library built before that area has the others' floats)."""
    if aa_mem and hasattr(lib, "qp_kernel_aa_workspace_floats"):
        return int(lib.qp_kernel_aa_workspace_floats(_AA_CODES[kernel], n, m, aa_mem))
    if kernel == "K1":
        return int(lib.sqp_step_workspace_floats(n, m))
    return int(lib.qp_solve_workspace_floats(n, m))


def _check_cuda_operands(name, named, dtypes):
    dev = None
    for key, t in named.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, expected a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, the rest on {dev}")
        want = dtypes.get(key, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, the CUDA kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def _check_shape(name, key, t, shape):
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _library():
    from sqp_solver_tpu_torch.ops import _build

    return _build.load()


def _raise_on(lib, rc, name):
    if rc != 0:
        # a library of the structured units alone (tools/kernel_ab.py's
        # forced builds) has no qp_kernel.cu, whose entry names the error
        text = getattr(lib, "qp_kernel_error_string", None)
        msg = text(rc).decode() if text is not None else "see cudaError_t"
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def sqp_step_kernel(
    B, J, g, l, u, s, dgl, reset, upd, active, x, z, y,
    settings: QPSettings,
    do_bfgs: bool = True,
    rho_in: Optional[torch.Tensor] = None,
    minv_in: Optional[torch.Tensor] = None,
    want_minv: bool = False,
) -> SQPStepOut:
    """Fused damped BFGS + posdef fallback + warm-started ADMM QP solve, one
    CUDA thread block per problem (replaces the TPU's
    ``ops/qp_kernel.py:sqp_step_kernel``).

    Shapes: B (B, n, n), J (B, m, n), g/s/dgl/x (B, n), l/u/z/y (B, m),
    reset/upd/active bool (B,), rho_in (B,), minv_in (B, n, n).  CPU
    tensors run :func:`sqp_step_reference`; CUDA tensors must be float32
    and contiguous and run the kernel."""
    batch, n = g.shape
    m = l.shape[-1]
    name = "sqp_step_kernel"
    for key, t, shape in (
        ("B", B, (batch, n, n)), ("J", J, (batch, m, n)), ("l", l, (batch, m)),
        ("u", u, (batch, m)), ("s", s, (batch, n)), ("dgl", dgl, (batch, n)),
        ("reset", reset, (batch,)), ("upd", upd, (batch,)),
        ("active", active, (batch,)), ("x", x, (batch, n)), ("z", z, (batch, m)),
        ("y", y, (batch, m)), ("rho_in", rho_in, (batch,)),
        ("minv_in", minv_in, (batch, n, n)),
    ):
        _check_shape(name, key, t, shape)
    if not g.is_cuda:
        return sqp_step_reference(
            B, J, g, l, u, s, dgl, reset, upd, active, x, z, y, settings,
            do_bfgs=do_bfgs, rho_in=rho_in, minv_in=minv_in, want_minv=want_minv,
        )
    return _sqp_step_launch(B, J, g, l, u, s, dgl, reset, upd, active, x, z, y, settings,
                            do_bfgs=do_bfgs, rho_in=rho_in, minv_in=minv_in,
                            want_minv=want_minv)


def _sqp_step_launch(B, J, g, l, u, s, dgl, reset, upd, active, x, z, y,
                     settings: QPSettings, do_bfgs: bool = True, rho_in=None, minv_in=None,
                     want_minv: bool = False, lib=None) -> SQPStepOut:
    """One launch of the SQP-step CUDA kernel on CUDA operands, from the
    package's library or from ``lib`` (another build of the kernels, as
    ``tools/kernel_ab.py`` passes)."""
    global sqp_step_launches
    batch, n = g.shape
    m = l.shape[-1]
    name = "sqp_step_kernel"
    operands = dict(B=B, J=J, g=g, l=l, u=u, s=s, dgl=dgl, reset=reset, upd=upd,
                    active=active, x=x, z=z, y=y, rho_in=rho_in, minv_in=minv_in)
    boolean = dict(reset=torch.bool, upd=torch.bool, active=torch.bool)
    dev = _check_cuda_operands(name, operands, boolean)
    lib = lib or _library()
    f32 = dict(dtype=torch.float32, device=dev)
    p_out = torch.empty((batch, n), **f32)
    z_out = torch.empty((batch, m), **f32)
    y_out = torch.empty((batch, m), **f32)
    B_out = torch.empty((batch, n, n), **f32)
    stats = torch.empty((9, batch), **f32)  # one contiguous row per field
    minv_out = torch.empty((batch, n, n), **f32) if want_minv else None
    aa_mem, aa_ws = _aa_workspace(lib, settings, batch, n, m, dev)
    ws_floats = _workspace_floats(lib, "K1", n, m, aa_mem)
    ws = torch.empty((batch * ws_floats,), **f32) if ws_floats > 0 else None
    seg, cpe, n_epochs = _schedule(settings)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        _ptr(B), _ptr(J), _ptr(g), _ptr(l), _ptr(u), _ptr(s), _ptr(dgl),
        _ptr(reset), _ptr(upd), _ptr(active), _ptr(rho_in), _ptr(minv_in),
        _ptr(x), _ptr(z), _ptr(y),
        _ptr(p_out), _ptr(z_out), _ptr(y_out), _ptr(B_out), _ptr(stats),
        _ptr(minv_out), _ptr(ws),
        batch, n, m,
        float(settings.sigma), float(settings.alpha), float(settings.rho),
        float(settings.eps_abs), float(settings.eps_rel),
        n_epochs, cpe, seg, int(bool(settings.adaptive_rho)),
        float(settings.adaptive_rho_tolerance), int(bool(do_bfgs)),
        dev.index, ctypes.c_void_p(stream),
    )
    # without Anderson the launch keeps the interface of the kernels before
    # it (tools/kernel_ab.py calls another tree's library through it)
    rc = (lib.sqp_step_launch_aa(*args, aa_mem, _ptr(aa_ws)) if aa_mem
          else lib.sqp_step_launch(*args))
    _raise_on(lib, rc, name)
    sqp_step_launches += 1
    i32 = torch.int32
    return SQPStepOut(
        p=p_out, z=z_out, y=y_out, B=B_out,
        done=stats[0] > 0.5, iter=stats[1].to(i32),
        res_prim=stats[2], res_dual=stats[3], fail=stats[4] > 0.5,
        rho_updates=stats[5].to(i32), rho_estimate=stats[6],
        rho_factor=stats[7], n_factor=stats[8].to(i32), minv=minv_out,
    )


# ---------------------------------------------------------------------------
# K2: the polish-KKT kernel
# ---------------------------------------------------------------------------


def _check_reuse(name, act_prev, li_prev):
    if act_prev is not None and li_prev is None:
        raise ValueError(f"{name}: act_prev requires li_prev (the previous call's emitted "
                         "L^-1): factorization reuse needs both")


def polish_kkt_reference(H, J, act, r1, b, nu0, delta: float = 1e-2,
                         sweeps: int = 6, x0=None, act_prev=None, li_prev=None,
                         fail_prev=None) -> PolishOut:
    """Plain version of the polish-KKT kernel: L^-1 of the Schur
    preconditioner M = H + delta I + (1/delta) Jm'Jm (Jm = J with inactive
    rows zeroed), then ``sweeps`` ideal-operator refinement sweeps on
    (x, nu) that apply M^-1 as Li'(Li t).  Same mathematics as the JAX
    ``_polish_kkt_body``.  With ``act_prev`` (and ``li_prev``, ``fail_prev``
    of the call that emitted it) a problem whose mask equals ``act_prev``
    takes ``li_prev`` as its L^-1 and ``fail_prev`` (default False) as its
    fail flag (the JAX kernel decides per tile of lanes, this per problem;
    the results are the same where ``li_prev`` came from the same (H, J))."""
    _check_reuse("polish_kkt_reference", act_prev, li_prev)
    dtype = H.dtype
    actf = act.to(dtype)
    inv_d = 1.0 / delta
    Jm = J * actf.unsqueeze(-1)
    Li, fail = _chol_inv_ltl(_schur_matrix(H, Jm, actf * inv_d, delta), ltl=False)
    if act_prev is not None:
        same = (act == act_prev).all(dim=-1)
        Li = torch.where(same[:, None, None], li_prev, Li)
        fail = torch.where(same, torch.zeros_like(fail) if fail_prev is None else fail_prev,
                           fail)
    nu = nu0 * actf
    if x0 is not None:
        x = x0
        w_n = _mv(H, x)
        w_m = _mv(Jm, x)
    else:
        x = torch.zeros_like(r1)
        w_n = torch.zeros_like(r1)
        w_m = torch.zeros_like(b)
    for _ in range(sweeps):
        res2 = actf * (b - w_m)
        t = r1 - w_n - _mtv(Jm, nu - inv_d * res2)
        v = _mv(Li, t)
        dx = _mtv(Li, v)
        dw_n = _mv(H, dx)
        dw_m = _mv(Jm, dx)
        nu = nu + actf * inv_d * (dw_m - res2)
        x = x + dx
        w_n = w_n + dw_n
        w_m = w_m + dw_m
    return PolishOut(x=x, nu=nu, fail=fail, li=Li)


def polish_kkt_kernel(H, J, act, r1, b, nu0, delta: float = 1e-2,
                      sweeps: int = 6, x0=None, act_prev=None, li_prev=None,
                      fail_prev=None) -> PolishOut:
    """Batched active-set KKT polish solve, one CUDA thread block per problem
    (replaces the TPU's ``ops/qp_kernel.py:polish_kkt_kernel``).

    H (B, n, n), J (B, m, n) raw Jacobian (masked by ``act`` inside),
    act bool (B, m), r1 (B, n) stationarity rhs, b (B, m) active-row
    targets, nu0 (B, m) multiplier warm start, optional x0 (B, n) primal
    warm start.  Factor reuse, as the JAX kernel's ``actt_prev`` /
    ``li_prev`` / ``fail_prev``: ``act_prev`` bool (B, m) and ``li_prev``
    (B, n, n), a previous call's mask and emitted ``li``, and optionally its
    ``fail`` (B,); a problem whose mask is unchanged skips the factor (sound
    only for the same (H, J), as in JAX).  CPU tensors run
    :func:`polish_kkt_reference`."""
    batch, n = r1.shape
    m = b.shape[-1]
    name = "polish_kkt_kernel"
    _check_reuse(name, act_prev, li_prev)
    if act_prev is None:
        li_prev = fail_prev = None  # as JAX: nothing to reuse
    for key, t, shape in (
        ("H", H, (batch, n, n)), ("J", J, (batch, m, n)), ("act", act, (batch, m)),
        ("nu0", nu0, (batch, m)), ("x0", x0, (batch, n)), ("act_prev", act_prev, (batch, m)),
        ("li_prev", li_prev, (batch, n, n)), ("fail_prev", fail_prev, (batch,)),
    ):
        _check_shape(name, key, t, shape)
    if not r1.is_cuda:
        return polish_kkt_reference(H, J, act, r1, b, nu0, delta, sweeps, x0, act_prev,
                                    li_prev, fail_prev)
    return _polish_kkt_launch(H, J, act, r1, b, nu0, delta, sweeps, x0, act_prev=act_prev,
                              li_prev=li_prev, fail_prev=fail_prev)


def _polish_kkt_launch(H, J, act, r1, b, nu0, delta: float, sweeps: int, x0=None,
                       lib=None, act_prev=None, li_prev=None, fail_prev=None) -> PolishOut:
    """One launch of the polish-KKT CUDA kernel on CUDA operands (``lib``
    as for :func:`_sqp_step_launch`); with ``act_prev`` (and ``li_prev``,
    as :func:`polish_kkt_kernel` passes them) its factor-reuse
    instantiation."""
    global polish_kkt_launches
    batch, n = r1.shape
    m = b.shape[-1]
    name = "polish_kkt_kernel"
    operands = dict(H=H, J=J, act=act, r1=r1, b=b, nu0=nu0, x0=x0, act_prev=act_prev,
                    li_prev=li_prev, fail_prev=fail_prev)
    dev = _check_cuda_operands(name, operands, dict(act=torch.bool, act_prev=torch.bool,
                                                    fail_prev=torch.bool))
    lib = lib or _library()
    f32 = dict(dtype=torch.float32, device=dev)
    x_out = torch.empty((batch, n), **f32)
    nu_out = torch.empty((batch, m), **f32)
    fail_out = torch.empty((batch,), dtype=torch.bool, device=dev)
    li_out = torch.empty((batch, n, n), **f32)
    ws_floats = int(lib.polish_kkt_workspace_floats(n, m))
    ws = torch.empty((batch * ws_floats,), **f32) if ws_floats > 0 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = (_ptr(H), _ptr(J), _ptr(act), _ptr(r1), _ptr(b), _ptr(nu0), _ptr(x0))
    outs = (_ptr(x_out), _ptr(nu_out), _ptr(fail_out), _ptr(li_out), _ptr(ws),
            batch, n, m, float(delta), int(sweeps), dev.index, ctypes.c_void_p(stream))
    if act_prev is None:
        rc = lib.polish_kkt_launch(*ins, *outs)
    else:
        rc = lib.polish_kkt_launch_reuse(*ins, _ptr(act_prev), _ptr(li_prev), _ptr(fail_prev),
                                         *outs)
    _raise_on(lib, rc, name)
    polish_kkt_launches += 1
    return PolishOut(x=x_out, nu=nu_out, fail=fail_out, li=li_out)


# ---------------------------------------------------------------------------
# K3: the whole-QP kernel
# ---------------------------------------------------------------------------


def _check_qp_settings(settings: QPSettings) -> None:
    settings.validate()
    if settings.check_comp_slack:
        raise ValueError(
            "check_comp_slack is not supported on the whole-solve kernel "
            "tiers (termination is evaluated in-kernel); use the fused or "
            "per-problem tier"
        )


def qp_solve_reference(P, A, q, l, u, x, z, y, settings: QPSettings) -> QPSolveOut:
    """Plain version of the whole-QP kernel: classify the rows, then the
    ADMM solve entered with a pending rho, so that the first epoch adopts
    rho0 and factors M = P + sigma I + A' diag(rho) A; rho epochs, chunks
    with per-problem early exit, adaptive rho and, with
    ``settings.check_infeasibility``, the infeasibility certificates."""
    batch = q.shape[0]
    seg, cpe, n_epochs = _schedule(settings)
    sigma = float(settings.sigma)
    # rho from q: a NaN in q's first entry poisons rho and so reaches the
    # fail flag through the factorization, as on the TPU
    rho = float(settings.rho) + 0.0 * q[:, 0]
    false = torch.zeros(batch, dtype=torch.bool, device=q.device)
    out = _admm_core(
        dense_ops(P, A), q, l, u, x, z, y, false, false, rho, torch.zeros_like(P),
        lambda rv: _factor(P, A, rv, sigma),
        sigma=sigma, alpha=float(settings.alpha),
        eps_abs=float(settings.eps_abs), eps_rel=float(settings.eps_rel),
        n_epochs=n_epochs, chunks_per_epoch=cpe, seg=seg,
        adaptive_rho=bool(settings.adaptive_rho),
        adaptive_rho_tolerance=float(settings.adaptive_rho_tolerance),
        pending=~false,
        check_infeas=bool(settings.check_infeasibility),
        eps_pinf=float(settings.eps_pinf), eps_dinf=float(settings.eps_dinf),
        **_aa_args(settings),
    )
    return QPSolveOut(
        x=out["x"], z=out["z"], y=out["y"], done=out["done"], iter=out["iter"],
        res_prim=out["res_prim"], res_dual=out["res_dual"], fail=out["fail"],
        rho_updates=out["rho_updates"], rho_estimate=out["rho_estimate"],
        infs=out["infs"],
    )


# K3's layouts: one warp a problem (n <= 32 and m <= 64, the rule of
# csrc/qp_kernel.cu:qp_warp_layout) or one block a problem (the rest)
QP_LAYOUTS = {"block": 1, "warp": 2}


def qp_solve_problems_per_block(n: int, m: int, lib=None) -> int:
    """Problems in one thread block of K3 at this shape: several under its
    warp layout (one warp a problem), else 1."""
    return int((lib or _library()).qp_solve_problems_per_block(n, m))


def _qp_solve_launch(P, A, q, l, u, x, z, y, settings: QPSettings, lib=None,
                     layout: Optional[str] = None) -> QPSolveOut:
    """One launch of the whole-QP CUDA kernel on float32 CUDA operands
    (``lib`` as for :func:`_sqp_step_launch`).  ``layout`` ("block" or
    "warp") overrides the kernel's own rule, for the card's tests; the warp
    layout refuses a shape outside its range."""
    global qp_solve_launches
    batch, n = q.shape
    m = l.shape[-1]
    name = "qp_solve_kernel"
    operands = dict(P=P, A=A, q=q, l=l, u=u, x=x, z=z, y=y)
    dev = _check_cuda_operands(name, operands, {})
    lib = lib or _library()
    f32 = dict(dtype=torch.float32, device=dev)
    x_out = torch.empty((batch, n), **f32)
    z_out = torch.empty((batch, m), **f32)
    y_out = torch.empty((batch, m), **f32)
    stats = torch.empty((8, batch), **f32)  # one contiguous row per field
    if layout is not None and layout not in QP_LAYOUTS:
        raise ValueError(f"{name}: layout {layout!r} is not one of {sorted(QP_LAYOUTS)}")
    aa_mem, aa_ws = _aa_workspace(lib, settings, batch, n, m, dev)
    ws_floats = _workspace_floats(lib, "K3-block", n, m, aa_mem)
    ws = torch.empty((batch * ws_floats,), **f32) if ws_floats > 0 else None
    seg, cpe, n_epochs = _schedule(settings)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        _ptr(P), _ptr(A), _ptr(q), _ptr(l), _ptr(u), _ptr(x), _ptr(z), _ptr(y),
        _ptr(x_out), _ptr(z_out), _ptr(y_out), _ptr(stats), _ptr(ws),
        batch, n, m,
        float(settings.sigma), float(settings.alpha), float(settings.rho),
        float(settings.eps_abs), float(settings.eps_rel),
        n_epochs, cpe, seg, int(bool(settings.adaptive_rho)),
        float(settings.adaptive_rho_tolerance),
        int(bool(settings.check_infeasibility)),
        float(settings.eps_pinf), float(settings.eps_dinf),
        dev.index, ctypes.c_void_p(stream),
    )
    code = 0 if layout is None else QP_LAYOUTS[layout]
    # without Anderson the launch keeps the interface of the kernels before
    # it (tools/kernel_ab.py calls another tree's library through it)
    if aa_mem:
        rc = lib.qp_solve_launch_aa(code, *args, aa_mem, _ptr(aa_ws))
    elif layout is None:
        rc = lib.qp_solve_launch(*args)
    else:
        rc = lib.qp_solve_launch_as(code, *args)
    _raise_on(lib, rc, name)
    qp_solve_launches += 1
    i32 = torch.int32
    return QPSolveOut(
        x=x_out, z=z_out, y=y_out, done=stats[0] > 0.5, iter=stats[1].to(i32),
        res_prim=stats[2], res_dual=stats[3], fail=stats[4] > 0.5,
        rho_updates=stats[5].to(i32), rho_estimate=stats[6], infs=stats[7].to(i32),
    )


def qp_status(out) -> torch.Tensor:
    """int32 QPStatus per problem, with the TPU kernel's precedence:
    failed > done > dual infeasible > primal infeasible > max iter."""
    return torch.where(
        out.fail, int(QPStatus.NUMERICAL_ISSUES),
        torch.where(
            out.done, int(QPStatus.SOLVED),
            torch.where(
                out.infs == 2, int(QPStatus.DUAL_INFEASIBLE),
                torch.where(out.infs == 1, int(QPStatus.PRIMAL_INFEASIBLE),
                            int(QPStatus.MAX_ITER_EXCEEDED)),
            ),
        ),
    ).to(torch.int32)


def qp_solve_kernel(qp: QuadraticProblem, settings: QPSettings = QPSettings(),
                    state: Optional[QPState] = None) -> QPResult:
    """Solve a batch of QPs with the whole-solve kernel, one CUDA warp per
    problem where n <= 32 and m <= 64, else one thread block per problem
    (replaces the TPU's ``ops/qp_kernel.py:qp_solve_kernel``).

    ``qp`` is batch-first (P (B, n, n), q (B, n), A (B, m, n), l and u
    (B, m)); ``state`` warm-starts (x, z, y), zeros otherwise.  CPU tensors
    run :func:`qp_solve_reference`; CUDA tensors must be float32 and
    contiguous and run the kernel.  With ``settings.polish`` the result goes
    through :func:`~sqp_solver_tpu_torch.qp.polish.polish_qp`.
    ``linear_solver="schur_block_tridiag"`` routes to the block-tridiagonal
    whole-QP kernel (:func:`~sqp_solver_tpu_torch.ops.qp_kernel_btd.qp_solve_kernel_btd`)."""
    if settings.linear_solver == "schur_block_tridiag":
        from sqp_solver_tpu_torch.ops.qp_kernel_btd import qp_solve_kernel_btd

        return qp_solve_kernel_btd(qp, settings, state)
    _check_qp_settings(settings)
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    batch, n = q.shape
    m = A.shape[-2]
    if state is None:
        state = QPState.zeros(batch, n, m, dtype=q.dtype, device=q.device)
    x0, z0, y0 = state.x, state.z, state.y
    name = "qp_solve_kernel"
    for key, t, shape in (
        ("P", P, (batch, n, n)), ("A", A, (batch, m, n)), ("l", l, (batch, m)),
        ("u", u, (batch, m)), ("x", x0, (batch, n)), ("z", z0, (batch, m)),
        ("y", y0, (batch, m)),
    ):
        _check_shape(name, key, t, shape)
    if q.is_cuda:
        out = _qp_solve_launch(P, A, q, l, u, x0, z0, y0, settings)
    else:
        out = qp_solve_reference(P, A, q, l, u, x0, z0, y0, settings)
    return qp_result(qp, out, settings)


def qp_result(qp: QuadraticProblem, out, settings: QPSettings) -> QPResult:
    """The QPResult of a whole-QP kernel's raw output (``QPSolveOut`` or
    the structured kernel's): statuses by :func:`qp_status`, x cut to the
    problem's n, and the polish with ``settings.polish``."""
    info = QPInfo(
        status=qp_status(out),
        iter=torch.clamp_max(out.iter, settings.max_iter),
        rho_updates=out.rho_updates,
        rho_estimate=out.rho_estimate,
        res_prim=out.res_prim,
        res_dual=out.res_dual,
    )
    result = QPResult(x=out.x[:, :qp.q.shape[-1]], y=out.y, z=out.z, info=info)
    if settings.polish:
        from sqp_solver_tpu_torch.qp.polish import polish_qp

        result = polish_qp(qp, result, settings)
    return result


# ---------------------------------------------------------------------------
# K4: the SPD-inverse kernel
# ---------------------------------------------------------------------------


def spd_inverse_reference(M):
    """Plain version of the SPD-inverse kernel: column Cholesky with the
    pivot clamp and fail rule, L^-1 by forward substitution, then L^-T L^-1.
    Returns ``(Minv (B, n, n), fail bool (B,))``."""
    return _chol_inv_ltl(M)


def spd_inverse_kernel(M):
    """Batched SPD inverse with a fail flag (replaces the TPU's
    ``ops/qp_kernel.py:spd_inverse_kernel``): one CUDA warp a problem, eight
    a block, at n <= 32, else one thread block a problem over the blocked
    factor in place (``csrc/qp_kernel.cu``).

    ``M`` is (B, n, n), symmetric (only its lower triangle is read).  CPU
    tensors run :func:`spd_inverse_reference`; CUDA tensors must be
    float32 and contiguous and run the kernel."""
    name = "spd_inverse_kernel"
    if M.dim() != 3 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"{name}: M has shape {tuple(M.shape)}, expected (B, n, n)")
    if not M.is_cuda:
        return spd_inverse_reference(M)
    return _spd_inverse_launch(M)


# K4's arms (csrc/qp_kernel.cu:SpdArm): the two that the raw launcher can
# force in place of the rule's, the column kernel (the earlier design,
# which the warp layout equals bit for bit) and the two-buffer blocked
# factor (K1's calls, which the blocked layout in place equals bit for
# bit), and the two that the rule (spd_rule_arm) picks, the warp layout at
# n <= 32 and the blocked layout in place above
SPD_ARMS = {"column": 1, "two-buffer": 2}
_SPD_ARM_NAMES = {1: "column", 2: "two-buffer", 3: "warp", 4: "blocked"}


def spd_inverse_problems_per_block(n: int, lib=None) -> int:
    """Problems in one thread block of K4 at n under its rule: several in
    the warp layout (one warp a problem), else 1."""
    return int((lib or _library()).spd_inverse_problems_per_block(n))


def spd_inverse_arm_info(n: int, device: int = 0, lib=None) -> dict:
    """What K4's launch at n takes under its rule, as the CUDA runtime
    reports it: the arm ("warp" or "blocked"), problems and threads a
    block, dynamic shared memory, registers and local (spill) bytes a
    thread, and blocks an SM by the occupancy calculator."""
    lib = lib or _library()
    out = (ctypes.c_int * 7)()
    rc = lib.spd_inverse_arm_info(n, device, out)
    _raise_on(lib, rc, "spd_inverse_arm_info")
    keys = ("arm", "problems_per_block", "threads", "smem_bytes", "registers",
            "local_bytes", "blocks_per_sm")
    info = dict(zip(keys, list(out)))
    info["arm"] = _SPD_ARM_NAMES[info["arm"]]
    return info


def _spd_inverse_launch(M, lib=None, arm: Optional[str] = None):
    """One launch of the SPD-inverse CUDA kernel on a CUDA operand (``lib``
    as for :func:`_sqp_step_launch`).  ``arm`` (a key of ``SPD_ARMS``)
    overrides the kernel's own rule, for the A/B tool and the card's
    tests."""
    global spd_inverse_launches
    name = "spd_inverse_kernel"
    dev = _check_cuda_operands(name, dict(M=M), {})
    batch, n, _ = M.shape
    lib = lib or _library()
    if arm is not None and arm not in SPD_ARMS:
        raise ValueError(f"{name}: arm {arm!r} is not one of {sorted(SPD_ARMS)}")
    minv = torch.empty((batch, n, n), dtype=torch.float32, device=dev)
    fail = torch.empty((batch,), dtype=torch.bool, device=dev)
    ws_floats = int(lib.spd_inverse_workspace_floats(n) if arm is None
                    else lib.spd_inverse_workspace_floats_as(SPD_ARMS[arm], n))
    ws = (torch.empty((batch * ws_floats,), dtype=torch.float32, device=dev)
          if ws_floats > 0 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (_ptr(M), _ptr(minv), _ptr(fail), _ptr(ws), batch, n, dev.index,
            ctypes.c_void_p(stream))
    rc = (lib.spd_inverse_launch(*args) if arm is None
          else lib.spd_inverse_launch_as(SPD_ARMS[arm], *args))
    _raise_on(lib, rc, name)
    spd_inverse_launches += 1
    return minv, fail
