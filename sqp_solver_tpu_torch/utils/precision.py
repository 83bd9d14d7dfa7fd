"""Solver-wide float32 precision pin (twin of ``sqp_solver_tpu/utils/precision.py``).

On Hopper a float32 matmul may run in TF32 (about three decimal digits),
the same hazard as the TPU's bf16 passes: the Schur/Cholesky pipeline
loses digits and ADMM stops converging.  ``pin_precision`` wraps every
solver entry point and switches TF32 off for the whole call, user
callables included (their autodiff feeds the QP data and the merit
values).  The previous settings are restored on exit.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["pin_precision"]


def pin_precision(fn):
    """Run ``fn`` with TF32 matmuls off and float32 matmul precision "highest"."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev_tf32 = torch.backends.cuda.matmul.allow_tf32
        prev_prec = torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev_tf32
            torch.set_float32_matmul_precision(prev_prec)

    return wrapped
