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
