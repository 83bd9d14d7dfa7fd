"""Constraint classification (twin of ``sqp_solver_tpu/qp/classify.py``).

Each row is loose / equality / inequality from its bounds (reference
``src/qp.cpp:284-314``); loose wins over equality.
"""

from __future__ import annotations

import torch

__all__ = [
    "INEQUALITY_CONSTRAINT",
    "EQUALITY_CONSTRAINT",
    "LOOSE_BOUNDS",
    "RHO_MIN",
    "RHO_MAX",
    "RHO_TOL",
    "RHO_EQ_FACTOR",
    "LOOSE_BOUNDS_THRESH",
    "constr_type_init",
    "rho_vec_from_type",
]

INEQUALITY_CONSTRAINT = 0
EQUALITY_CONSTRAINT = 1
LOOSE_BOUNDS = 2

RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_TOL = 1e-4
RHO_EQ_FACTOR = 1e3
LOOSE_BOUNDS_THRESH = 1e16


def constr_type_init(l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """int32 codes {INEQUALITY_CONSTRAINT, EQUALITY_CONSTRAINT, LOOSE_BOUNDS}
    per row (reference truth table ``src/qp.cpp:284-294``)."""
    loose = (l < -LOOSE_BOUNDS_THRESH) & (u > LOOSE_BOUNDS_THRESH)
    equality = (u - l) < RHO_TOL
    codes = torch.where(equality, EQUALITY_CONSTRAINT, INEQUALITY_CONSTRAINT)
    return torch.where(loose, LOOSE_BOUNDS, codes).to(torch.int32)


def rho_vec_from_type(constr_type: torch.Tensor, rho0, dtype) -> torch.Tensor:
    """Per-row rho: RHO_MIN on loose rows, RHO_EQ_FACTOR * rho0 on equality
    rows, rho0 otherwise (reference ``src/qp.cpp:297-314``).  ``rho0`` is a
    number or a tensor that broadcasts against ``constr_type``."""
    r = torch.as_tensor(rho0, dtype=dtype, device=constr_type.device)
    r = r.expand(torch.broadcast_shapes(r.shape, constr_type.shape))
    return torch.where(
        constr_type == LOOSE_BOUNDS,
        torch.full_like(r, RHO_MIN),
        torch.where(constr_type == EQUALITY_CONSTRAINT, RHO_EQ_FACTOR * r, r),
    )
