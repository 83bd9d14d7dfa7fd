"""Sustained (receding-horizon) NLP serving: K dependent, warm-started
batch SQP solves (twin of ``sqp_solver_tpu/sqp/sequence.py``).

The nonlinear twin of :func:`sqp_solver_tpu_torch.qp.sequence.qp_solve_sequence`:
between steps the loop carries the previous step's primal/dual solution
as the next step's (x0, lam0), the standard receding-horizon SQP warm
start.  A Python loop takes the place of the JAX package's ``lax.scan``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from sqp_solver_tpu_torch.qp.sequence import stack_outputs
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = ["sqp_solve_sequence"]


def sqp_solve_sequence(
    make_nlp: Callable[[Any], Tuple[NonlinearProblem, torch.Tensor]],
    advance: Callable[[Any, SQPResult], Tuple[Any, Any]],
    carry0: Any,
    num_steps: int,
    settings: SQPSettings = SQPSettings(),
    impl: str = "fused",
    warm0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Run ``num_steps`` dependent, warm-started batch NLP solves.

    ``make_nlp(carry) -> (problem, x0)``; its ``x0`` (B, n) seeds the
    first step only, unless ``warm0 = (x0, lam0)`` is given.
    ``advance(carry, result) -> (next_carry, output)``.  Returns
    ``(outputs, final_carry, (x_f, lam_f))`` with the outputs stacked on
    a new leading axis; pass ``(x_f, lam_f)`` back as ``warm0`` to resume."""
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch

    carry = carry0
    if warm0 is None:
        prob0, x00 = make_nlp(carry0)
        B = x00.shape[0]
        m = prob0.l.shape[-1]
        warm0 = (x00, torch.zeros((B, m), dtype=x00.dtype, device=x00.device))
    xw, lamw = warm0
    outs = []
    for _ in range(num_steps):
        prob, _ = make_nlp(carry)
        res = sqp_solve_batch(prob, xw, lamw, settings, impl=impl)
        carry, out = advance(carry, res)
        xw, lamw = res.x, res.lam
        outs.append(out)
    return stack_outputs(outs), carry, (xw, lamw)
