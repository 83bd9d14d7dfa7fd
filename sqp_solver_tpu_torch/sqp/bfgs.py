"""Damped BFGS update, Procedure 18.2 of Nocedal & Wright (twin of
``sqp_solver_tpu/sqp/bfgs.py``, reference ``include/solvers/bfgs.hpp:14-41``).

Damping where s'y < 0.2 s'Bs keeps B positive definite; the update is
skipped where the damped curvature s'r falls below machine epsilon.  One
batch-first function serves every tier: the per-problem tier, the fused
tier, the plain version of the SQP-step kernel (K1) and the kernel tier
under scaling, where the update runs outside K1.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["bfgs_update"]


def bfgs_update(B: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                reset: Optional[torch.Tensor] = None,
                upd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank-2 damped update of ``B`` (..., n, n) with step ``s`` and
    gradient change ``y`` (..., n).  NaN-safe at s = 0 (B comes back
    unchanged).  Optional per-problem masks (...,): ``reset`` gives the
    identity, and where ``upd`` is False B passes through."""
    dtype = B.dtype
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    Bs = torch.matmul(B, s.unsqueeze(-1)).squeeze(-1)
    sBs = (s * Bs).sum(-1)
    sy = (s * y).sum(-1)
    damped = sy < 0.2 * sBs
    # safe denominators: where `damped` holds, sBs - sy > 0.8 sBs >= 0
    theta = 0.8 * sBs / torch.clamp_min(sBs - sy, tiny)
    th = theta.unsqueeze(-1)
    r = torch.where(damped.unsqueeze(-1), th * y + (1.0 - th) * Bs, y)
    sr = torch.where(damped, theta * sy + (1.0 - theta) * sBs, sy)
    B_new = (
        B
        - (Bs.unsqueeze(-1) * Bs.unsqueeze(-2)) / torch.clamp_min(sBs, tiny)[..., None, None]
        + (r.unsqueeze(-1) * r.unsqueeze(-2)) / torch.clamp_min(sr, tiny)[..., None, None]
    )
    keep = sr < eps
    if upd is not None:
        keep = keep | ~upd
    out = torch.where(keep[..., None, None], B, B_new)
    if reset is not None:
        eye = torch.eye(B.shape[-1], dtype=dtype, device=B.device)
        out = torch.where(reset[..., None, None], eye, out)
    return out
