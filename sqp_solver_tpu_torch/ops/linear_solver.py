"""KKT linear solver of the fused ADMM tier (twin of the ``schur_cholesky``
backend of ``sqp_solver_tpu/ops/linear_solver.py``).

The dual block of the quasi-definite KKT matrix is eliminated, leaving the
SPD Schur matrix M = P + sigma I + A' diag(rho) A, which is factored once
per rho epoch into an explicit inverse.  From it the fused iteration
operator W = [[Minv, Minv A'], [A Minv, A Minv A']] turns one ADMM
iteration's linear algebra into one matvec, the product the chunk kernel
K5 applies ``seg`` times per launch.

The JAX package computes this factor with XLA, not Pallas, so here it is
plain PyTorch: ``cholesky_ex``, a triangular solve against I, one
Newton-Schulz step and matmuls, at full float32 under the caller's
``pin_precision``.  Only this backend is ported; the fused tier refuses
the others by name.
"""

from __future__ import annotations

import torch


def _eye_like(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def _schur_matrix(P, A, sigma, rho_vec):
    """M = P + sigma I + A' diag(rho) A."""
    return P + sigma * _eye_like(P) + torch.matmul(A.mT, rho_vec.unsqueeze(-1) * A)


def _schur_factor(P, A, sigma, rho_vec):
    """``(W, Minv)``: the fused operator W from the Cholesky-based explicit
    inverse of the Schur matrix.  A problem whose M is not SPD gets a NaN L, as
    ``jnp.linalg.cholesky`` gives, so its Minv and W are NaN and the fused
    tier marks it failed (``isnan(W).any()``)."""
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
    return W, Minv


def _fused_admm_operator(Minv, A):
    """[[G1, G2], [A G1, A G2]] with G1 = Minv and G2 = Minv A'."""
    G2 = torch.matmul(Minv, A.mT)
    top = torch.cat([Minv, G2], dim=-1)
    bottom = torch.cat([torch.matmul(A, Minv), torch.matmul(A, G2)], dim=-1)
    return torch.cat([top, bottom], dim=-2)
