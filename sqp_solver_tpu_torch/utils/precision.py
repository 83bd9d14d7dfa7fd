"""Solver-wide float32 precision pin (twin of ``sqp_solver_tpu/utils/precision.py``).

On Hopper a float32 matmul may run in TF32 (about three decimal digits),
the same hazard as the TPU's bf16 passes: the Schur/Cholesky pipeline
loses digits and ADMM stops converging.  ``pin_precision`` wraps every
solver entry point and switches TF32 off for the whole call, user
callables included (their autodiff feeds the QP data and the merit
values).  The previous settings are restored on exit.  ``hmat`` and
``hdot`` are one product each under the same pin.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["hdot", "hmat", "pin_precision"]


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


@pin_precision
def hmat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in full float32 (TF32 off)."""
    return torch.matmul(a, b)


@pin_precision
def hdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``numpy.dot`` semantics (a sum over the last axis of ``a`` and the
    second to last of ``b``, or its only one) in full float32."""
    return torch.tensordot(a, b, dims=([a.dim() - 1], [max(b.dim() - 2, 0)]))
