"""Sustained (receding-horizon) QP serving: K dependent, warm-started
batch solves (twin of ``sqp_solver_tpu/qp/sequence.py``).

Each control step rebuilds the QP from a user carry (the plant state),
solves the batch warm-started from the previous step's iterate, consumes
the result and advances the carry.  A Python loop takes the place of the
JAX package's ``lax.scan``: the semantics are those of calling
:func:`~sqp_solver_tpu_torch.parallel.batch.qp_solve_batch` K times with
the state threaded by hand.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from sqp_solver_tpu_torch.qp.types import QPResult, QPSettings, QPState, QuadraticProblem

__all__ = ["qp_solve_sequence", "stack_outputs"]


def stack_outputs(outs: list):
    """Stack per-step outputs along a new leading axis: tensors, Python
    numbers, and tuples, lists or dicts of them (nested)."""
    head = outs[0]
    if isinstance(head, torch.Tensor):
        return torch.stack(outs)
    if isinstance(head, dict):
        return {k: stack_outputs([o[k] for o in outs]) for k in head}
    if isinstance(head, (tuple, list)):
        parts = [stack_outputs([o[i] for o in outs]) for i in range(len(head))]
        return type(head)(parts) if isinstance(head, list) else tuple(parts)
    if head is None:
        return None
    return torch.as_tensor(outs)


def qp_solve_sequence(
    make_qp: Callable[[Any], QuadraticProblem],
    advance: Callable[[Any, QPResult], Tuple[Any, Any]],
    carry0: Any,
    num_steps: int,
    settings: QPSettings = QPSettings(),
    impl: str = "kernel",
    state0: Optional[QPState] = None,
):
    """Run ``num_steps`` dependent, warm-started batch QP solves.

    ``make_qp(carry)`` gives a batch-first :class:`QuadraticProblem`;
    ``advance(carry, result) -> (next_carry, output)`` consumes the step's
    :class:`QPResult`.  ``state0`` warm-starts the first step (zeros of the
    first QP's shape otherwise).  Returns ``(outputs, final_carry,
    final_state)``: the per-step outputs stacked on a new leading axis of
    length ``num_steps``, the carry after the last step and the last
    step's :class:`QPState` (pass it back as ``state0`` to resume)."""
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    carry, state = carry0, state0
    if state is None:
        qp0 = make_qp(carry0)
        B, n = qp0.q.shape
        m = qp0.l.shape[-1]
        state = QPState.zeros(B, n, m, dtype=qp0.q.dtype, device=qp0.q.device)
    outs = []
    for _ in range(num_steps):
        res = qp_solve_batch(make_qp(carry), settings, state=state, impl=impl)
        carry, out = advance(carry, res)
        state = res.state
        outs.append(out)
    return stack_outputs(outs), carry, state
