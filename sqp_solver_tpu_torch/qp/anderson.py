"""Safeguarded type-II Anderson acceleration (twin of
``sqp_solver_tpu/qp/anderson.py``).

The chunk map T of the fused tier is a fixed-point map of u = (x, z, y);
AA extrapolates through the last ``memory`` chunk outputs from ring
buffers of differences, solving Levenberg-regularized k x k normal
equations per problem.  The tier projects the candidate back onto the box
and decides per problem whether to accept it; it resets a problem's
buffers when a rho refactor changes the map (``prev_ok``, ``pairs``).
Leading batch dimensions are optional.
"""

from __future__ import annotations

import torch

__all__ = ["anderson_init", "anderson_extrapolate", "gauss_jordan"]


def anderson_init(batch_shape, memory, dim, dtype, device=None):
    """Fresh AA state: ``batch_shape`` is () for one problem or (B,);
    ``dim`` is the packed iterate length."""
    batch_shape = tuple(batch_shape)

    def z(*shape, dt=dtype):
        return torch.zeros(batch_shape + shape, dtype=dt, device=device)

    return dict(dU=z(memory, dim), dF=z(memory, dim), uT_prev=z(dim), f_prev=z(dim),
                prev_ok=z(dt=torch.bool), pairs=z(dt=torch.int32))


def gauss_jordan(G, rhs):
    """Solve G gamma = rhs (batch-first, G (..., k, k), rhs (..., k, 1)) by
    Gauss-Jordan without pivoting, in the order of the JAX whole-solve
    kernel's statically unrolled elimination (its diagonal is >= the
    Levenberg term > 0), which the CUDA kernels repeat."""
    k = G.shape[-1]
    G = G.clone()
    rhs = rhs.clone()
    for i in range(k):
        inv_piv = 1.0 / G[..., i:i + 1, i:i + 1]
        row_i = G[..., i:i + 1, :] * inv_piv
        r_i = rhs[..., i:i + 1, :] * inv_piv
        fac = G[..., :, i:i + 1].clone()
        fac[..., i, :] = 0.0
        G = G - fac * row_i
        rhs = rhs - fac * r_i
        G[..., i:i + 1, :] = row_i
        rhs[..., i:i + 1, :] = r_i
    return rhs


def anderson_extrapolate(aa, u_in, u_T, memory, solve=torch.linalg.solve):
    """One AA-II step: push the newest (u_T, f) differences into the ring
    buffers and solve the regularized normal equations (by ``solve``: the
    fused tier's library solve, or the whole-solve kernels'
    :func:`gauss_jordan`).

    Returns ``(u_aa, pairs, aa_new)``: the raw extrapolated candidate (the
    caller projects and safeguards it), the pair count (0 means no
    history: the caller must not accept) and the updated state."""
    dtype = u_T.dtype
    f = u_T - u_in
    have_prev = aa["prev_ok"]

    def roll(buf, col):
        pushed = torch.cat([buf[..., 1:, :], col.unsqueeze(-2)], dim=-2)
        return torch.where(have_prev[..., None, None], pushed, buf)

    dU = roll(aa["dU"], u_T - aa["uT_prev"])
    dF = roll(aa["dF"], f - aa["f_prev"])
    pairs = torch.clamp_max(aa["pairs"] + have_prev.to(torch.int32), memory)
    # the newest pairs sit at the end of the ring
    ar = torch.arange(memory, device=u_T.device)
    valid = ar >= (memory - pairs).unsqueeze(-1)
    zero = torch.zeros((), dtype=dtype, device=u_T.device)
    dFm = torch.where(valid.unsqueeze(-1), dF, zero)
    dUm = torch.where(valid.unsqueeze(-1), dU, zero)
    G = torch.matmul(dFm, dFm.mT)
    # Levenberg regularization, and the identity on unused rows (their rhs
    # is zero, so their gamma is exactly zero)
    reg = 1e-8 * (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) + 1.0)
    eye_k = torch.eye(memory, dtype=dtype, device=u_T.device)
    G = G + (reg[..., None, None] + (~valid).to(dtype).unsqueeze(-1) * eye_k) * eye_k
    rhs = torch.matmul(dFm, f.unsqueeze(-1))
    gamma = solve(G, rhs).squeeze(-1)
    u_aa = u_T - torch.matmul(gamma.unsqueeze(-2), dUm).squeeze(-2)
    aa_new = dict(dU=dU, dF=dF, uT_prev=u_T, f_prev=f,
                  prev_ok=torch.ones_like(have_prev), pairs=pairs)
    return u_aa, pairs, aa_new
