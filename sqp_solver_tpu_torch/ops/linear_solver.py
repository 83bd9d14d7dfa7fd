"""KKT linear solvers of the ADMM tiers (twin of
``sqp_solver_tpu/ops/linear_solver.py``, the ``schur_cholesky`` backend).

The dual block of the quasi-definite KKT matrix is eliminated, leaving the
SPD Schur matrix M = P + sigma I + A' diag(rho) A, which is factored once
per rho epoch into an explicit inverse.  From it the fused iteration
operator W = [[Minv, Minv A'], [A Minv, A Minv A']] turns one ADMM
iteration's linear algebra into one matvec: the product the chunk kernel
K5 applies ``seg`` times per launch (the fused tier), and the per-problem
tier (:mod:`sqp_solver_tpu_torch.qp.admm`) applies once per iteration.

The JAX package computes this factor with XLA, not Pallas, so here it is
plain PyTorch: ``cholesky_ex``, a triangular solve against I, one
Newton-Schulz step and matmuls, at full float32 under the caller's
``pin_precision``.  The registry (:func:`get_linear_solver`) holds this
backend only; the JAX package's others raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

__all__ = ["LinearSolver", "get_linear_solver"]

# the JAX registry's other backends, ported by ROADMAP Queue 1 item 10
_NOT_PORTED = ("schur_cholesky_tri", "schur_cholesky_blocked", "kkt_ldlt", "cg",
               "schur_block_tridiag", "schur_arrow")


def _eye_like(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def _mv(M, v):
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _schur_matrix(P, A, sigma, rho_vec):
    """M = P + sigma I + A' diag(rho) A."""
    return P + sigma * _eye_like(P) + torch.matmul(A.mT, rho_vec.unsqueeze(-1) * A)


def _schur_factor_parts(P, A, sigma, rho_vec) -> dict:
    """The factor as the JAX backend's dict ``{W, Minv, M, diag_nan}``.  A
    problem whose M is not SPD gets a NaN L, as ``jnp.linalg.cholesky``
    gives, so its Minv and W are NaN and ``diag_nan`` is set."""
    M = _schur_matrix(P, A, sigma, rho_vec)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")), L)
    eye = _eye_like(M)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(M), upper=False)
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


class LinearSolver(NamedTuple):
    """factor(P, A, sigma, rho_vec) -> factor dict;
    solve(factor, P, A, sigma, rho_vec, rhs1, rhs2, refine_steps) -> x~;
    solve_xz(...) -> (x~, z~), the fused per-iteration op;
    is_failure(factor) -> bool per problem."""

    factor: Callable[..., Any]
    solve: Callable[..., torch.Tensor]
    solve_xz: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    is_failure: Callable[[Any], torch.Tensor]


_REGISTRY = {
    "schur_cholesky": LinearSolver(_schur_factor_parts, _schur_solve, _schur_solve_xz,
                                   _schur_is_failure),
}


def get_linear_solver(name: str, block_size: int = 0, arrow_width: int = 0) -> LinearSolver:
    """The backend ``name``; only ``"schur_cholesky"`` is ported."""
    del block_size, arrow_width  # read by the structured backends only
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"linear_solver={name!r} is not ported (ROADMAP Queue 1, item 10 "
            "'Linear-solver backends')"
        )
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown linear_solver {name!r}; available: {sorted((*_REGISTRY, *_NOT_PORTED))}"
        ) from None
