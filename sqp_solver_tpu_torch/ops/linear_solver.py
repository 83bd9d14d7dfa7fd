"""KKT linear solvers of the ADMM tiers (twin of
``sqp_solver_tpu/ops/linear_solver.py``).

Each backend is a :class:`LinearSolver` of batch-first functions (factor,
solve, the fused per-iteration ``solve_xz`` and ``is_failure``, per
problem), taken by name from :func:`get_linear_solver`:

* ``schur_cholesky`` (the default): the dual block of the quasi-definite
  KKT matrix is eliminated, leaving the SPD Schur matrix M = P + sigma I +
  A' diag(rho) A, factored once per rho epoch into an explicit inverse.
  From it the fused iteration operator W = [[Minv, Minv A'], [A Minv,
  A Minv A']] turns one ADMM iteration's linear algebra into one matvec:
  the product the chunk kernel K5 applies ``seg`` times per launch (the
  fused tier), and the per-problem tier (:mod:`sqp_solver_tpu_torch.qp.admm`)
  applies once per iteration;
* ``kkt_ldlt``: the pivot-free LDL' of the whole quasi-definite KKT
  matrix, with a pivot floor 0.05 min(sigma, 1 / max rho);
* ``cg``: Jacobi-preconditioned conjugate gradient on the Schur operator;
* ``schur_cholesky_tri``: the Cholesky factor kept, two triangular solves
  an iteration;
* ``schur_cholesky_blocked``: the explicit inverse by a Cholesky and a
  triangular inverse in panels of 512 (the large-n backend);
* ``schur_block_tridiag``: the block-Thomas factor of a block-tridiagonal
  M and its two sweeps, batched small matmuls over the stages (the
  per-problem and fused tiers' structured backend; the whole-solve tier
  runs it in the K6/K7 kernel instead);
* ``schur_arrow``: an arrow-structured M (block diagonal, bordered by a
  dense coupling strip) inverted by its closed-form bordered inverse from
  batched Cholesky factors of the blocks, then used like the default
  backend's explicit inverse (the per-problem and fused tiers).

The JAX package computes all of them with XLA, not Pallas, so here they are
plain PyTorch, at full float32 under the caller's ``pin_precision``.  A
factor that breaks down gives NaN, as ``jnp.linalg.cholesky`` does, and the
backend's ``is_failure`` reports it.  The matrix-free ``cg`` also takes a
:class:`~sqp_solver_tpu_torch.ops.block_sparse.BlockSparse` P or A: the
operand helpers :func:`_mv`, :func:`_rmv`, :func:`_diag` and
:func:`_sq_col_sums` take dense and block-sparse operands alike.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from sqp_solver_tpu_torch.ops.block_sparse import BlockSparse
from sqp_solver_tpu_torch.utils.host import any_live

__all__ = ["LinearSolver", "get_linear_solver", "ldlt_factor", "ldlt_solve"]

# CG tests on the host whether any problem still iterates once every this
# many trips (the problems that have finished are frozen in between)
CG_HOST_CHECK_TRIPS = 8


def _eye_like(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def _mv(M, v, prepared=None):
    """M v over a leading batch, for a dense or a BlockSparse M (with its
    strips ``prepared`` by ``M.prepare(False)``, if given)."""
    if isinstance(M, BlockSparse):
        return M.mv(v, prepared)
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _rmv(M, w, prepared=None):
    """M' w, dense or BlockSparse (strips by ``M.prepare(True)``)."""
    if isinstance(M, BlockSparse):
        return M.rmv(w, prepared)
    return torch.matmul(w.unsqueeze(-2), M).squeeze(-2)


def _diag(M):
    """The diagonal of a square M, dense or BlockSparse."""
    if isinstance(M, BlockSparse):
        return M.diag()
    return torch.diagonal(M, dim1=-2, dim2=-1)


def _sq_col_sums(A, w):
    """sum_r w_r A[r, :]^2, the diagonal of A' diag(w) A, dense or
    BlockSparse."""
    if isinstance(A, BlockSparse):
        return A.with_data(A.data * A.data).rmv(w)
    return (w.unsqueeze(-1) * A * A).sum(-2)


def _dot(a, b):
    return (a * b).sum(-1)


def _cholesky_nan(M):
    """Lower Cholesky, NaN for a problem whose M is not SPD (as
    ``jnp.linalg.cholesky`` gives)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")), L)


def _tri_inverse(L):
    """L^-1 of a lower-triangular batch by a triangular solve against I."""
    return torch.linalg.solve_triangular(L, _eye_like(L).expand_as(L), upper=False)


def _schur_matrix(P, A, sigma, rho_vec):
    """M = P + sigma I + A' diag(rho) A."""
    return P + sigma * _eye_like(P) + torch.matmul(A.mT, rho_vec.unsqueeze(-1) * A)


def _schur_factor_parts(P, A, sigma, rho_vec) -> dict:
    """The factor as the JAX backend's dict ``{W, Minv, M, diag_nan}``.  A
    problem whose M is not SPD gets a NaN L, as ``jnp.linalg.cholesky``
    gives, so its Minv and W are NaN and ``diag_nan`` is set."""
    M = _schur_matrix(P, A, sigma, rho_vec)
    L = _cholesky_nan(M)
    eye = _eye_like(M)
    Li = _tri_inverse(L)
    Minv = torch.matmul(Li.mT, Li)
    # one Newton-Schulz step X <- X (2I - M X): the inverse's error
    # contracts quadratically, near-backsolve accuracy in float32
    Minv = torch.matmul(Minv, 2.0 * eye - torch.matmul(M, Minv))
    # rho stays in the VECTOR operand (rho .* z - y), never in W: entries
    # of size rho (up to RHO_MAX = 1e6) in W destroy the cancellation of
    # z - y / rho (the JAX package measured 4e-2 error that way, against
    # 1e-13 with the rho-free W)
    W = _fused_admm_operator(Minv, A)
    return {"W": W, "Minv": Minv, "M": M, "diag_nan": torch.isnan(L).flatten(-2).any(-1)}


def _schur_factor(P, A, sigma, rho_vec):
    """``(W, Minv)`` of :func:`_schur_factor_parts`, the fused tier's form."""
    f = _schur_factor_parts(P, A, sigma, rho_vec)
    return f["W"], f["Minv"]


def _fused_admm_operator(Minv, A):
    """[[G1, G2], [A G1, A G2]] with G1 = Minv and G2 = Minv A'."""
    G2 = torch.matmul(Minv, A.mT)
    top = torch.cat([Minv, G2], dim=-1)
    bottom = torch.cat([torch.matmul(A, Minv), torch.matmul(A, G2)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _schur_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    """x~ = Minv (rhs1 + A' (rho .* rhs2)), with ``refine_steps`` rounds of
    iterative refinement against the exact M."""
    b = rhs1 + _mv(A.mT, rho_vec * rhs2)
    x = _mv(factor["Minv"], b)
    for _ in range(refine_steps):
        r = b - _mv(factor["M"], x)
        x = x + _mv(factor["Minv"], r)
    return x


def _schur_solve_xz(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    """(x~, z~) of one ADMM iteration: one matvec with W, or, with
    refinement (which needs the residual against M), the two-op route."""
    if refine_steps > 0:
        x = _schur_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps)
        return x, _mv(A, x)
    n = rhs1.shape[-1]
    xz = _mv(factor["W"], torch.cat([rhs1, rho_vec * rhs2], dim=-1))
    return xz[..., :n], xz[..., n:]


def _schur_is_failure(factor):
    """Per problem: the factorization broke down."""
    return factor["diag_nan"] | torch.isnan(factor["Minv"]).flatten(-2).any(-1)


# ---------------------------------------------------------------------------
# kkt_ldlt: the pivot-free LDL' of the whole KKT matrix
# ---------------------------------------------------------------------------


def ldlt_factor(K):
    """Pivot-free LDL' of a symmetric quasi-definite batch K (..., N, N) by
    right-looking rank-1 updates: (unit-lower L, diagonal d)."""
    N = K.shape[-1]
    idx = torch.arange(N, device=K.device)
    W = K.clone()
    L = torch.zeros_like(K)
    d = torch.zeros(K.shape[:-1], dtype=K.dtype, device=K.device)
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    for j in range(N):
        dj = W[..., j, j]
        col = torch.where(idx > j, W[..., :, j] / dj.unsqueeze(-1), zero)
        W = W - dj[..., None, None] * (col.unsqueeze(-1) * col.unsqueeze(-2))
        L[..., :, j] = col
        d[..., j] = dj
    return L + _eye_like(K), d


def ldlt_solve(L, d, b):
    w = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False, unitriangular=True)
    w = w / d.unsqueeze(-1)
    return torch.linalg.solve_triangular(L.mT, w, upper=True, unitriangular=True).squeeze(-1)


def _kkt_matrix(P, A, sigma, rho_vec):
    top = torch.cat([P + sigma * _eye_like(P), A.mT], dim=-1)
    bot = torch.cat([A, torch.diag_embed(-1.0 / rho_vec)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _kkt_factor(P, A, sigma, rho_vec):
    K = _kkt_matrix(P, A, sigma, rho_vec)
    L, d = ldlt_factor(K)
    # the quasi-definite pivot bound min(sigma, 1 / rho_max) (Vanderbei
    # 1995), loosened 20x for float32 roundoff on sigma-level pivots
    pivot_floor = 0.05 * torch.clamp_max(1.0 / rho_vec.amax(-1), sigma)
    return {"L": L, "d": d, "K": K, "pivot_floor": pivot_floor}


def _kkt_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    n = rhs1.shape[-1]
    b = torch.cat([rhs1, rhs2], dim=-1)
    s = ldlt_solve(factor["L"], factor["d"], b)
    for _ in range(refine_steps):
        s = s + ldlt_solve(factor["L"], factor["d"], b - _mv(factor["K"], s))
    return s[..., :n]


def _kkt_is_failure(factor):
    """A NaN pivot, or one below the quasi-definite floor recorded at factor
    time (a threshold relative to the largest pivot would flag the valid
    sigma-level pivots of a KKT matrix whose pivots span [sigma, rho_max])."""
    d = factor["d"]
    return torch.isnan(d).any(-1) | (d.abs() < factor["pivot_floor"].unsqueeze(-1)).any(-1)


# ---------------------------------------------------------------------------
# cg: matrix-free conjugate gradient on the Schur operator
# ---------------------------------------------------------------------------


def _cg_factor(P, A, sigma, rho_vec):
    """The Jacobi preconditioner diag(M), floored at the smallest normal.
    A BlockSparse P or A also gets its strip arrays here (``P_mv``,
    ``A_mv``, ``A_rmv``), outside the CG loop, so that no gather of tiles
    rides an iteration."""
    diag_M = _diag(P) + sigma + _sq_col_sums(A, rho_vec)
    factor = {"jacobi": torch.clamp_min(diag_M, torch.finfo(diag_M.dtype).tiny)}
    if isinstance(P, BlockSparse):
        factor["P_mv"] = P.prepare(False)
    if isinstance(A, BlockSparse):
        factor["A_mv"] = A.prepare(False)
        factor["A_rmv"] = A.prepare(True)
    return factor


def _cg_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    """Jacobi-preconditioned CG on M x = rhs1 + A' (rho .* rhs2) from x = 0,
    per problem until r'r <= (10 eps)^2 max(b'b, eps) or 4n trips; a
    non-positive p'Ap poisons the iterate with NaN (it never reports
    SOLVED).  The batch runs one loop: a problem whose own condition fails
    is frozen (``torch.where``), so each gets the trips of a solve alone,
    and the host asks whether any problem still iterates once every
    :data:`CG_HOST_CHECK_TRIPS` trips."""
    del refine_steps
    n = rhs1.shape[-1]
    dinv = 1.0 / factor["jacobi"]

    strips = factor.get

    def mv(v):
        Av = _mv(A, v, strips("A_mv"))
        return _mv(P, v, strips("P_mv")) + sigma * v + _rmv(A, rho_vec * Av, strips("A_rmv"))

    b = rhs1 + _rmv(A, rho_vec * rhs2, strips("A_rmv"))
    eps = torch.finfo(b.dtype).eps
    tol2 = (10.0 * eps) ** 2 * torch.clamp_min(_dot(b, b), eps)
    nan = torch.full((), float("nan"), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    p = dinv * r
    zr = _dot(r, p)
    k = torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device)
    for trip in range(4 * n):
        live = (_dot(r, r) > tol2) & (k < 4 * n)
        if trip % CG_HOST_CHECK_TRIPS == 0 and not any_live(live):
            break
        Ap = mv(p)
        pAp = _dot(p, Ap)
        alpha = (zr / torch.where(pAp > 0.0, pAp, nan)).unsqueeze(-1)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = dinv * r_n
        zr_n = _dot(r_n, z)
        p_n = z + (zr_n / zr).unsqueeze(-1) * p
        l1 = live.unsqueeze(-1)
        x, r, p = torch.where(l1, x_n, x), torch.where(l1, r_n, r), torch.where(l1, p_n, p)
        zr = torch.where(live, zr_n, zr)
        k = k + live.to(torch.int32)
    return x


def _cg_is_failure(factor):
    return torch.isnan(factor["jacobi"]).any(-1)


# ---------------------------------------------------------------------------
# schur_cholesky_tri: the Cholesky factor and two triangular solves
# ---------------------------------------------------------------------------


def _schur_tri_factor(P, A, sigma, rho_vec):
    M = _schur_matrix(P, A, sigma, rho_vec)
    L = _cholesky_nan(M)
    return {"L": L, "M": M, "diag_nan": torch.isnan(L).flatten(-2).any(-1)}


def _schur_tri_solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
    b = rhs1 + _rmv(A, rho_vec * rhs2)
    L = factor["L"]

    def cho(v):
        w = torch.linalg.solve_triangular(L, v.unsqueeze(-1), upper=False)
        return torch.linalg.solve_triangular(L.mT, w, upper=True).squeeze(-1)

    x = cho(b)
    for _ in range(refine_steps):
        x = x + cho(b - _mv(factor["M"], x))
    return x


def _schur_tri_is_failure(factor):
    return factor["diag_nan"]


# ---------------------------------------------------------------------------
# schur_cholesky_blocked: the explicit inverse by blocks (large n)
# ---------------------------------------------------------------------------


def _blocked_cholesky(M, bs=512):
    """Right-looking blocked Cholesky: each diagonal block by a Cholesky, the
    panel below by one matmul with its inverse transpose, the trailing
    matrix by one rank-bs matmul.  Returns lower L."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    T = M
    for k in range(0, n, bs):
        b = min(bs, n - k)
        L_kk = _cholesky_nan(T[..., :b, :b])
        L[..., k:k + b, k:k + b] = L_kk
        panel = torch.matmul(T[..., b:, :b], _tri_inverse(L_kk).mT)
        L[..., k + b:, k:k + b] = panel
        T = T[..., b:, b:] - torch.matmul(panel, panel.mT)
    return L


def _blocked_tri_inv(L, bs=512):
    """L^-1 by block forward substitution: X_ij = -L_ii^-1 sum_{j<=k<i}
    L_ik X_kj, the off-diagonal work in matmuls."""
    n = L.shape[-1]
    starts = list(range(0, n, bs))
    spans = [(s0, min(s0 + bs, n)) for s0 in starts]
    Li = torch.zeros_like(L)
    inv_diag = [_tri_inverse(L[..., i0:i1, i0:i1]) for i0, i1 in spans]
    for j, (j0, j1) in enumerate(spans):
        Li[..., j0:j1, j0:j1] = inv_diag[j]
        for i in range(j + 1, len(spans)):
            i0, i1 = spans[i]
            acc = torch.matmul(L[..., i0:i1, j0:j1], inv_diag[j])
            for kk in range(j + 1, i):
                k0, k1 = spans[kk]
                acc = acc + torch.matmul(L[..., i0:i1, k0:k1], Li[..., k0:k1, j0:j1])
            Li[..., i0:i1, j0:j1] = -torch.matmul(inv_diag[i], acc)
    return Li


def _schur_blocked_factor(P, A, sigma, rho_vec):
    """Blocked Cholesky, blocked triangular inverse, one matmul for Minv and
    one Newton-Schulz step; every per-iteration solve is then one matvec."""
    M = _schur_matrix(P, A, sigma, rho_vec)
    n = M.shape[-1]
    bs = 512 if n >= 1024 else max(128, n // 4)
    L = _blocked_cholesky(M, bs=bs)
    Li = _blocked_tri_inv(L, bs=bs)
    Minv = torch.matmul(Li.mT, Li)
    Minv = torch.matmul(Minv, 2.0 * _eye_like(M) - torch.matmul(M, Minv))
    return {"Minv": Minv, "M": M, "diag_nan": torch.isnan(L).flatten(-2).any(-1)}


# ---------------------------------------------------------------------------
# schur_block_tridiag: block-Thomas Cholesky of a block-tridiagonal M
# ---------------------------------------------------------------------------


def _btd_blocks(M, b):
    """Diagonal blocks D (..., T, b, b) and sub-diagonal blocks E (..., T, b,
    b; the last zero) of M."""
    n = M.shape[-1]
    T = n // b
    Mb = M.reshape(M.shape[:-2] + (T, b, T, b))
    D = torch.stack([Mb[..., k, :, k, :] for k in range(T)], dim=-3)
    E = torch.zeros_like(D)
    for k in range(T - 1):
        E[..., k, :, :] = Mb[..., k + 1, :, k, :]
    return D, E


def _btd_factory(b: int) -> "LinearSolver":
    def factor(P, A, sigma, rho_vec):
        """M = L L' with block-bidiagonal L: diagonal blocks L_k =
        chol(D_k - F_{k-1} F_{k-1}'), sub-diagonal blocks F_k = E_k L_k^-T.
        Entries of M outside the band are ignored."""
        M = _schur_matrix(P, A, sigma, rho_vec)
        D, E = _btd_blocks(M, b)
        T = D.shape[-3]
        Li, F = torch.empty_like(D), torch.empty_like(D)
        FF = torch.zeros_like(D[..., 0, :, :])
        for k in range(T):
            Lk_inv = _tri_inverse(_cholesky_nan(D[..., k, :, :] - FF))
            Fk = torch.matmul(E[..., k, :, :], Lk_inv.mT)
            Li[..., k, :, :] = Lk_inv
            F[..., k, :, :] = Fk
            FF = torch.matmul(Fk, Fk.mT)
        return {"Li": Li, "F": F, "M": M, "diag_nan": torch.isnan(Li).flatten(-3).any(-1)}

    def btd_solve(factor, v):
        Li, F = factor["Li"], factor["F"]
        T = Li.shape[-3]
        vb = v.reshape(v.shape[:-1] + (T, b))
        w = torch.zeros_like(vb[..., 0, :])
        W = []
        for k in range(T):  # w_k = L_k^-1 (b_k - F_{k-1} w_{k-1})
            rhs = vb[..., k, :] - (_mv(F[..., k - 1, :, :], w) if k else 0.0)
            w = _mv(Li[..., k, :, :], rhs)
            W.append(w)
        x = torch.zeros_like(w)
        X = [None] * T
        for k in reversed(range(T)):  # x_k = L_k^-T (w_k - F_k' x_{k+1})
            x = _rmv(Li[..., k, :, :], W[k] - _rmv(F[..., k, :, :], x))
            X[k] = x
        return torch.stack(X, dim=-2).reshape(v.shape)

    def solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
        bvec = rhs1 + _rmv(A, rho_vec * rhs2)
        x = btd_solve(factor, bvec)
        for _ in range(refine_steps):
            x = x + btd_solve(factor, bvec - _mv(factor["M"], x))
        return x

    return LinearSolver(factor, solve, _fallback_solve_xz(solve), lambda f: f["diag_nan"])


# ---------------------------------------------------------------------------
# schur_arrow: the bordered inverse of an arrow-structured M
# ---------------------------------------------------------------------------


def _arrow_factory(b: int, c: int) -> "LinearSolver":
    def factor(P, A, sigma, rho_vec):
        """M = [[D, B], [B', C]] with D = blkdiag(D_1..D_T) of (b, b) blocks
        and a dense (c, c) border C; entries of M outside the arrow are
        ignored.  The closed-form bordered inverse

            Dinv = blkdiag(D_k^-1),  W = Dinv B,  S = C - B' W,  X = W S^-1,
            M^-1 = [[Dinv + X W', -X], [-X', S^-1]]

        from batched (T, b, b) Cholesky factors (one Newton-Schulz step per
        block and one for S^-1), then one full Newton-Schulz step against M,
        gives the explicit inverse and the fused operator of the default
        backend, so an iteration costs what it costs there."""
        M = _schur_matrix(P, A, sigma, rho_vec)
        n = M.shape[-1]
        T = (n - c) // b
        nd = T * b
        lead = M.shape[:-2]
        # the (T, b, b) diagonal blocks of the leading part, by one diagonal
        # view of its (T, b, T, b) layout
        Dblk = M[..., :nd, :nd].reshape(lead + (T, b, T, b)).diagonal(dim1=-4, dim2=-2)
        Dblk = Dblk.movedim(-1, -3)  # (..., T, b, b)
        Bblk = M[..., :nd, nd:].reshape(lead + (T, b, c))
        C = M[..., nd:, nd:]
        Ld = _cholesky_nan(Dblk)
        Li = _tri_inverse(Ld)
        Dinv = torch.matmul(Li.mT, Li)
        # each block's inverse is corrected before composition, since the
        # bordered inverse inherits every block's error
        Dinv = torch.matmul(Dinv, 2.0 * _eye_like(Dblk) - torch.matmul(Dblk, Dinv))
        W = torch.matmul(Dinv, Bblk)
        S = C - torch.einsum("...tbc,...tbd->...cd", Bblk, W)
        Ls = _cholesky_nan(S)
        Lsi = _tri_inverse(Ls)
        Sinv = torch.matmul(Lsi.mT, Lsi)
        Sinv = torch.matmul(Sinv, 2.0 * _eye_like(S) - torch.matmul(S, Sinv))
        X = torch.matmul(W, Sinv.unsqueeze(-3))  # (..., T, b, c)
        TL = M.new_zeros(lead + (T, b, T, b))
        TL.diagonal(dim1=-4, dim2=-2).copy_(Dinv.movedim(-3, -1))
        TL = (TL + torch.einsum("...tic,...ujc->...tiuj", X, W)).reshape(lead + (nd, nd))
        Xf = X.reshape(lead + (nd, c))
        Minv = torch.cat([torch.cat([TL, -Xf], dim=-1),
                          torch.cat([-Xf.mT, Sinv], dim=-1)], dim=-2)
        # one full Newton-Schulz step against M: the composed inverse's
        # error contracts quadratically (without it float32 ADMM stalls at
        # blocks of 32, as the JAX package measured)
        Minv = torch.matmul(Minv, 2.0 * _eye_like(M) - torch.matmul(M, Minv))
        diag_nan = torch.isnan(Ld).flatten(-3).any(-1) | torch.isnan(Ls).flatten(-2).any(-1)
        return {"W": _fused_admm_operator(Minv, A), "Minv": Minv, "M": M,
                "diag_nan": diag_nan}

    return LinearSolver(factor, _schur_solve, _schur_solve_xz, _schur_is_failure)


class LinearSolver(NamedTuple):
    """factor(P, A, sigma, rho_vec) -> factor dict;
    solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps) -> x~;
    solve_xz(...) -> (x~, z~), the fused per-iteration op;
    is_failure(factor) -> bool per problem."""

    factor: Callable[..., Any]
    solve: Callable[..., torch.Tensor]
    solve_xz: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    is_failure: Callable[[Any], torch.Tensor]


def _fallback_solve_xz(solve):
    """solve_xz of a backend without a fused operator: x~, then z~ = A x~."""
    def solve_xz(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps):
        x = solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps)
        return x, _mv(A, x)

    return solve_xz


_REGISTRY = {
    "schur_cholesky": LinearSolver(_schur_factor_parts, _schur_solve, _schur_solve_xz,
                                   _schur_is_failure),
    "kkt_ldlt": LinearSolver(_kkt_factor, _kkt_solve, _fallback_solve_xz(_kkt_solve),
                             _kkt_is_failure),
    "cg": LinearSolver(_cg_factor, _cg_solve, _fallback_solve_xz(_cg_solve), _cg_is_failure),
    "schur_cholesky_tri": LinearSolver(_schur_tri_factor, _schur_tri_solve,
                                       _fallback_solve_xz(_schur_tri_solve),
                                       _schur_tri_is_failure),
    "schur_cholesky_blocked": LinearSolver(_schur_blocked_factor, _schur_solve,
                                           _fallback_solve_xz(_schur_solve),
                                           _schur_tri_is_failure),
}


def get_linear_solver(name: str, block_size: int = 0, arrow_width: int = 0) -> LinearSolver:
    """The backend ``name`` (``block_size`` for ``schur_block_tridiag``;
    ``block_size`` and ``arrow_width`` for ``schur_arrow``)."""
    if name == "schur_block_tridiag":
        if block_size <= 0:
            raise ValueError(
                "linear_solver='schur_block_tridiag' requires settings.block_size > 0"
            )
        return _btd_factory(block_size)
    if name == "schur_arrow":
        if block_size <= 0 or arrow_width <= 0:
            raise ValueError(
                "linear_solver='schur_arrow' requires settings.block_size > 0 "
                "and settings.arrow_width > 0"
            )
        return _arrow_factory(block_size, arrow_width)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown linear_solver {name!r}; available: "
            f"{sorted(_REGISTRY) + ['schur_arrow', 'schur_block_tridiag']}"
        ) from None
