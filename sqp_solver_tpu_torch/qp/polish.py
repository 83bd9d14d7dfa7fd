"""Active-set guess for the polish epilogue (twin of the
``active_masks`` / ``guess_active_set`` part of
``sqp_solver_tpu/qp/polish.py``)."""

from __future__ import annotations

import torch

from sqp_solver_tpu_torch.qp.classify import RHO_TOL

__all__ = ["active_masks", "guess_active_set"]


def active_masks(l, u, y):
    """``(eq, act_low, act_up)``: equality rows (u - l < RHO_TOL) and rows
    whose dual is meaningfully negative / positive."""
    eq = (u - l) < RHO_TOL
    ytol = 1e-5 * (1.0 + y.abs().amax(dim=-1, keepdim=True))
    act_low = (y < -ytol) & ~eq
    act_up = (y > ytol) & ~eq
    return eq, act_low, act_up


def guess_active_set(l, u, y):
    """OSQP-style guess from dual signs, equality rows always active.
    Returns ``(act, b)`` with ``b`` the target on active rows, 0 elsewhere."""
    eq, act_low, act_up = active_masks(l, u, y)
    act = act_low | act_up | eq
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    b = torch.where(
        eq, 0.5 * (l + u), torch.where(act_low, l, torch.where(act_up, u, zero))
    )
    return act, torch.where(act, b, zero)
