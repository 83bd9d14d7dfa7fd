"""Reference problem fixtures (twin of ``sqp_solver_tpu/models/problems.py``).

Each constructor cites the reference test it reproduces; the expected
optimum ships beside it as ``*_SOLUTION``.  The NLPs follow this
package's :class:`~sqp_solver_tpu_torch.sqp.types.NonlinearProblem`
convention: batched callables of x (B, n) with shared bounds (m,), so one
fixture serves a single ``x0`` (n,) and a batch of starts.  The default
dtype is float64 and the default device the card.
"""

from __future__ import annotations

import numpy as np
import torch

from sqp_solver_tpu_torch.qp.types import QuadraticProblem
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = [
    "simple_qp",
    "SIMPLE_QP_SOLUTION",
    "simple_nlp",
    "SIMPLE_NLP_SOLUTION",
    "simple_qp_nlp",
    "constrained_rosenbrock_2d",
    "CONSTRAINED_ROSENBROCK_2D_SOLUTION",
    "rosenbrock",
    "rosenbrock_box",
    "simple_nlp2",
    "SIMPLE_NLP2_SOLUTION",
]

INF = float("inf")

SIMPLE_QP_SOLUTION = np.array([0.3, 0.7])
SIMPLE_NLP_SOLUTION = np.array([1.0, 1.0])
CONSTRAINED_ROSENBROCK_2D_SOLUTION = np.array([0.707106781, 0.707106781])
SIMPLE_NLP2_SOLUTION = np.array([-1.0, -1.0])


def _t(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=resolve_device(device))


def simple_qp(dtype=torch.float64, device=None) -> QuadraticProblem:
    """2-var/3-constraint QP, one problem without the batch axis, optimum
    [0.3, 0.7] (reference tests/qp_solver_test.cpp:12-41)."""
    return QuadraticProblem(
        P=_t([[4.0, 1.0], [1.0, 2.0]], dtype, device),
        q=_t([1.0, 1.0], dtype, device),
        A=_t([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]], dtype, device),
        l=_t([1.0, 0.0, 0.0], dtype, device),
        u=_t([1.0, 0.7, 0.7], dtype, device),
    )


def simple_nlp(dtype=torch.float64, device=None) -> NonlinearProblem:
    """min -(x0 + x1) s.t. 1 <= ||x||^2 <= 2, x >= 0; optimum [1, 1]
    (reference tests/sqp_test.cpp:8-44)."""
    return NonlinearProblem(
        l=_t([1.0, 0.0, 0.0], dtype, device),
        u=_t([2.0, INF, INF], dtype, device),
        objective=lambda x, p: -x.sum(-1),
        constraint=lambda x, p: torch.cat([(x * x).sum(-1, keepdim=True), x], dim=-1),
    )


def simple_qp_nlp(dtype=torch.float64, device=None) -> NonlinearProblem:
    """The SimpleQP posed as an NLP with hand-coded linearizations
    (reference tests/sqp_test.cpp:92-124); optimum [0.3, 0.7]."""
    P = _t([[4.0, 1.0], [1.0, 2.0]], dtype, device)
    q = _t([1.0, 1.0], dtype, device)
    J = torch.cat([torch.ones((1, 2), dtype=dtype, device=P.device),
                   torch.eye(2, dtype=dtype, device=P.device)], dim=0)

    def objective(x, p):
        return 0.5 * (x * torch.matmul(x, P.mT)).sum(-1) + (x * q).sum(-1)

    def objective_linearized(x, p):
        return objective(x, p), torch.matmul(x, P.mT) + q

    def constraint(x, p):
        return torch.cat([x.sum(-1, keepdim=True), x], dim=-1)

    def constraint_linearized(x, p):
        return constraint(x, p), J.expand(x.shape[0], 3, 2)

    return NonlinearProblem(
        l=_t([1.0, 0.0, 0.0], dtype, device),
        u=_t([1.0, 0.7, 0.7], dtype, device),
        objective=objective,
        constraint=constraint,
        objective_linearized=objective_linearized,
        constraint_linearized=constraint_linearized,
    )


def rosenbrock(x, a=1.0, b=100.0):
    """n-D Rosenbrock over the last axis (reference
    tests/sqp_test_autodiff.cpp:61-71)."""
    return ((a - x[..., :-1]) ** 2 + b * (x[..., 1:] - x[..., :-1] ** 2) ** 2).sum(-1)


def constrained_rosenbrock_2d(dtype=torch.float64, device=None) -> NonlinearProblem:
    """2-D Rosenbrock s.t. x <= y and ||x||^2 == 1; optimum
    [sqrt(2)/2, sqrt(2)/2] (reference tests/sqp_test_autodiff.cpp:73-99)."""
    return NonlinearProblem(
        l=_t([-INF, 1.0], dtype, device),
        u=_t([0.0, 1.0], dtype, device),
        objective=lambda x, p: rosenbrock(x),
        constraint=lambda x, p: torch.stack([x[..., 0] - x[..., 1], (x * x).sum(-1)], dim=-1),
    )


def rosenbrock_box(n: int, dtype=torch.float64, device=None) -> NonlinearProblem:
    """n-D Rosenbrock with box constraints 0 <= x <= 1; optimum the ones
    vector (reference tests/sqp_test_autodiff.cpp:122-144)."""
    dev = resolve_device(device)
    return NonlinearProblem(
        l=torch.zeros((n,), dtype=dtype, device=dev),
        u=torch.ones((n,), dtype=dtype, device=dev),
        objective=lambda x, p: rosenbrock(x),
        constraint=lambda x, p: 1.0 * x,
    )


def simple_nlp2(dtype=torch.float64, device=None) -> NonlinearProblem:
    """Nocedal & Wright Example 12.1: min x0 + x1 s.t. ||x||^2 == 2; optimum
    [-1, -1] (reference tests/sqp_test_autodiff.cpp:244-265)."""
    return NonlinearProblem(
        l=_t([2.0], dtype, device),
        u=_t([2.0], dtype, device),
        objective=lambda x, p: x.sum(-1),
        constraint=lambda x, p: (x * x).sum(-1, keepdim=True),
    )
