"""OSQP section 3.4 infeasibility certificates from ADMM iterate deltas
(twin of ``sqp_solver_tpu/qp/infeasibility.py``).

A nonzero ``dy`` with ``A'dy ~ 0`` and support ``u'(dy)_+ + l'(dy)_- < 0``
proves that no x satisfies ``l <= Ax <= u`` (primal infeasible); a nonzero
``dx`` with ``P dx ~ 0``, ``q'dx < 0`` and ``A dx`` a recession direction
of the box proves the objective unbounded below (dual infeasible).  Loose
bounds (beyond +-LOOSE_BOUNDS_THRESH, possibly infinite) enter the support
as +-1e20, which keeps the sums finite.  P and A may each be dense or
BlockSparse (:mod:`sqp_solver_tpu_torch.ops.block_sparse`).
"""

from __future__ import annotations

import torch

from sqp_solver_tpu_torch.ops.linear_solver import _mv, _rmv
from sqp_solver_tpu_torch.qp.classify import LOOSE_BOUNDS_THRESH

__all__ = ["infeasibility_certificates"]

_BIG = 1e20


def _linf(v):
    return v.abs().amax(dim=-1)


def infeasibility_certificates(P, A, q, l, u, dx, dy, eps_pinf, eps_dinf):
    """Both certificates for a batch of QPs (leading batch dimensions).
    Returns bool masks ``(primal_infeasible, dual_infeasible)``.  The
    products dispatch per operand, dense or BlockSparse."""
    norm_dy = _linf(dy)
    ATdy = _rmv(A, dy)
    u_eff = torch.where(u > LOOSE_BOUNDS_THRESH, torch.full_like(u, _BIG), u)
    l_eff = torch.where(l < -LOOSE_BOUNDS_THRESH, torch.full_like(l, -_BIG), l)
    sup = (u_eff * torch.clamp_min(dy, 0.0) + l_eff * torch.clamp_max(dy, 0.0)).sum(-1)
    prim = (norm_dy > 0.0) & (_linf(ATdy) <= eps_pinf * norm_dy) & (sup <= -eps_pinf * norm_dy)

    norm_dx = _linf(dx)
    Adx = _mv(A, dx)
    tol = (eps_dinf * norm_dx).unsqueeze(-1)
    ray_ok = (
        (~(u <= LOOSE_BOUNDS_THRESH) | (Adx <= tol))
        & (~(l >= -LOOSE_BOUNDS_THRESH) | (Adx >= -tol))
    ).all(-1)
    dual = (
        (norm_dx > 0.0)
        & (_linf(_mv(P, dx)) <= eps_dinf * norm_dx)
        & ((q * dx).sum(-1) <= -eps_dinf * norm_dx)
        & ray_ok
    )
    return prim, dual
