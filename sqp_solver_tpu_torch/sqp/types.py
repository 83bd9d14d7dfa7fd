"""SQP problem, settings, status and result containers (twin of
``sqp_solver_tpu/sqp/types.py``).

The problem's callables are **batched** torch functions: every call sees
the whole batch, ``x (B, n)`` and ``params`` with a leading B (or None).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import torch

from sqp_solver_tpu_torch.qp.types import QPSettings

__all__ = [
    "NonlinearProblem",
    "SQPSettings",
    "SQPStatus",
    "SQPInfo",
    "SQPResult",
]


class SQPStatus(enum.IntEnum):
    """Same codes as the JAX package (reference ``sqp.hpp:33`` plus
    NUMERICAL_ISSUES for per-problem failure isolation)."""

    SOLVED = 0
    MAX_ITER_EXCEEDED = 1
    INVALID_SETTINGS = 2
    NUMERICAL_ISSUES = 3


@dataclasses.dataclass(frozen=True)
class NonlinearProblem:
    """``minimize f(x)  s.t.  l <= c(x) <= u`` for a batch of problems.

    * ``objective(x, params) -> (B,)`` and ``constraint(x, params) -> (B, m)``
      are batched torch functions of ``x (B, n)``; ``params`` is a tensor
      with a leading B, or None.  They must be written with ops that
      ``torch.func`` can transform when a derivative hook is missing.
    * ``objective_linearized(x, params) -> (obj (B,), grad (B, n))``
      optionally replaces autodiff of the objective.
    * ``constraint_linearized(x, params) -> (c (B, m), J (B, m, n))`` and
      ``lagrangian_hessian(x, lam, params) -> (B, n, n)`` are the
      batch-first counterparts of the JAX package's
      ``constraint_linearized_t`` and ``lagrangian_hessian_t`` hooks.
      When missing, ``torch.func`` supplies them (``vmap`` over ``jacfwd``
      / ``jacrev`` and ``hessian`` of one problem).

    ``l`` and ``u`` are (B, m), or (m,) shared by the whole batch.
    """

    l: torch.Tensor
    u: torch.Tensor
    params: Any = None
    objective: Optional[Callable] = None
    constraint: Optional[Callable] = None
    objective_linearized: Optional[Callable] = None
    constraint_linearized: Optional[Callable] = None
    lagrangian_hessian: Optional[Callable] = None

    @property
    def num_constr(self) -> int:
        return self.l.shape[-1]


@dataclasses.dataclass(frozen=True)
class SQPSettings:
    """SQP hyperparameters; names, defaults and ``validate()`` as in the JAX
    package (reference ``sqp.hpp:13-31``)."""

    tau: float = 0.5
    eta: float = 0.25
    rho: float = 0.5
    eps_prim: float = 1e-4
    eps_dual: float = 1e-4
    max_iter: int = 100
    line_search_max_iter: int = 20
    second_order_correction: bool = False
    qp: QPSettings = QPSettings(
        rho=1e-1,
        sigma=1e-6,
        alpha=1.6,
        eps_rel=1e-4,
        eps_abs=1e-4,
        max_iter=100,
        check_termination=10,
        warm_start=True,
        adaptive_rho=True,
        adaptive_rho_interval=50,
        check_infeasibility=False,
    )
    qp_warm_start: bool = True
    qp_impl: str = "fused"
    polish: bool = False
    polish_passes: int = 2
    polish_delta: float = 1e-2
    polish_sweeps: int = 6
    jacobian_mode: str = "fwd"
    termination: str = "step_norm"
    schedule: str = "early_exit"
    # called as iteration_callback(x (B, n), lam (B, m), k) once with the
    # initial point (k = 0) and after every outer iteration
    iteration_callback: Optional[Callable] = None
    record_trace: bool = False

    def validate(self) -> None:
        if not (0.0 < self.tau < 1.0):
            raise ValueError(f"tau must be in (0,1), got {self.tau}")
        if not (0.0 < self.eta < 1.0):
            raise ValueError(f"eta must be in (0,1), got {self.eta}")
        if not (0.0 < self.rho < 1.0):
            raise ValueError(f"rho must be in (0,1), got {self.rho}")
        if not (self.eps_prim > 0.0 and self.eps_dual > 0.0):
            raise ValueError("eps_prim/eps_dual must be > 0")
        if self.max_iter <= 0 or self.line_search_max_iter <= 0:
            raise ValueError("max_iter/line_search_max_iter must be > 0")
        if self.polish_passes < 0:
            raise ValueError("polish_passes must be >= 0")
        if not (self.polish_delta > 0.0):
            raise ValueError("polish_delta must be > 0")
        if self.polish_sweeps < 1:
            raise ValueError("polish_sweeps must be >= 1")
        if self.jacobian_mode not in ("fwd", "rev"):
            raise ValueError(f"jacobian_mode must be 'fwd' or 'rev', got {self.jacobian_mode}")
        if self.termination not in ("step_norm", "kkt"):
            raise ValueError(
                f"termination must be 'step_norm' or 'kkt', got {self.termination}"
            )
        if self.schedule not in ("early_exit", "fixed"):
            raise ValueError(
                f"schedule must be 'early_exit' or 'fixed', got {self.schedule}"
            )
        if self.qp_impl not in ("fused", "kernel", "kernel_btd"):
            raise ValueError(
                "qp_impl must be 'fused', 'kernel' or 'kernel_btd', "
                f"got {self.qp_impl}"
            )
        if self.qp_impl == "kernel_btd" and self.qp.block_size <= 0:
            raise ValueError("qp_impl='kernel_btd' requires qp.block_size > 0")
        self.qp.validate()


@dataclasses.dataclass(frozen=True)
class SQPInfo:
    """Per-problem diagnostics, each (B,)."""

    status: torch.Tensor  # int32 SQPStatus code
    iter: torch.Tensor  # int32
    qp_solver_iter: torch.Tensor  # int32, accumulated inner iterations
    primal_step_norm: torch.Tensor
    dual_step_norm: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SQPResult:
    x: torch.Tensor  # (B, n)
    lam: torch.Tensor  # (B, m)
    info: SQPInfo
    # with settings.record_trace: dict of per-outer-iteration tensors
    # "x" (max_iter, B, n), "lam" (max_iter, B, m), "alpha",
    # "primal_step_norm", "dual_step_norm" (max_iter, B)
    trace: Any = None
