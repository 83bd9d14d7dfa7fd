"""QP settings, state and status (twin of ``sqp_solver_tpu/qp/types.py``).

Field names, defaults, ``validate()`` and the integer status codes are
those of the JAX package, so settings move across one to one.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = [
    "QuadraticProblem",
    "QPSettings",
    "QPStatus",
    "QPInfo",
    "QPState",
    "QPResult",
]


class QPStatus(enum.IntEnum):
    """Same codes as the JAX package (reference enum ``qp.hpp:70`` plus the
    OSQP §3.4 infeasibility certificates)."""

    SOLVED = 0
    MAX_ITER_EXCEEDED = 1
    UNSOLVED = 2
    NUMERICAL_ISSUES = 3
    UNINITIALIZED = 4
    PRIMAL_INFEASIBLE = 5
    DUAL_INFEASIBLE = 6


@dataclasses.dataclass(frozen=True)
class QuadraticProblem:
    """``minimize 0.5 x'Px + q'x  s.t.  l <= Ax <= u`` for a batch, batch
    first: P (B, n, n), q (B, n), A (B, m, n), l and u (B, m).  ``polish_qp``
    also takes one problem without the batch axis."""

    P: torch.Tensor  # (B, n, n) cost Hessian, PSD
    q: torch.Tensor  # (B, n) cost linear term
    A: torch.Tensor  # (B, m, n) constraint matrix
    l: torch.Tensor  # (B, m) lower bounds (-inf allowed)
    u: torch.Tensor  # (B, m) upper bounds (+inf allowed)

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    def astype(self, dtype) -> "QuadraticProblem":
        return QuadraticProblem(*(v.to(dtype) for v in (self.P, self.q, self.A, self.l, self.u)))


@dataclasses.dataclass(frozen=True)
class QPSettings:
    """ADMM hyperparameters; see the JAX twin for what each knob does."""

    rho: float = 1e-1
    sigma: float = 1e-6
    alpha: float = 1.0
    eps_rel: float = 1e-3
    eps_abs: float = 1e-3
    max_iter: int = 1000
    check_termination: int = 25
    warm_start: bool = False
    adaptive_rho: bool = False
    adaptive_rho_tolerance: float = 5.0
    adaptive_rho_interval: int = 25
    verbose: bool = False
    linear_solver: str = "schur_cholesky"
    block_size: int = 0
    arrow_width: int = 0
    refine_steps: int = 0
    schedule: str = "early_exit"
    polish: bool = False
    polish_delta: float = 1e-2
    polish_sweeps: int = 6
    check_comp_slack: bool = False
    polish_passes: int = 2
    scaling: int = 0
    acceleration: str = "none"
    anderson_memory: int = 4
    check_infeasibility: bool = True
    eps_pinf: float = 1e-4
    eps_dinf: float = 1e-4

    def validate(self) -> None:
        if not (self.rho > 0):
            raise ValueError(f"rho must be > 0, got {self.rho}")
        if not (self.sigma > 0):
            raise ValueError(f"sigma must be > 0, got {self.sigma}")
        if not (0 < self.alpha < 2):
            raise ValueError(f"alpha must be in (0, 2), got {self.alpha}")
        if not (self.eps_rel > 0 and self.eps_abs > 0):
            raise ValueError("eps_rel/eps_abs must be > 0")
        if self.max_iter <= 0 or self.check_termination < 0:
            raise ValueError("max_iter must be > 0, check_termination >= 0")
        if not (self.adaptive_rho_tolerance > 1):
            raise ValueError("adaptive_rho_tolerance must be > 1")
        if self.adaptive_rho_interval <= 0:
            raise ValueError("adaptive_rho_interval must be > 0")
        if self.linear_solver not in (
            "schur_cholesky", "schur_cholesky_tri", "schur_cholesky_blocked",
            "kkt_ldlt", "cg", "schur_block_tridiag", "schur_arrow",
        ):
            raise ValueError(f"unknown linear_solver {self.linear_solver!r}")
        if self.linear_solver == "schur_block_tridiag" and self.block_size <= 0:
            raise ValueError(
                "linear_solver='schur_block_tridiag' requires block_size > 0"
            )
        if self.linear_solver == "schur_arrow" and (
            self.block_size <= 0 or self.arrow_width <= 0
        ):
            raise ValueError(
                "linear_solver='schur_arrow' requires block_size > 0 and "
                "arrow_width > 0"
            )
        if not (self.polish_delta > 0.0):
            raise ValueError("polish_delta must be > 0")
        if self.polish_sweeps < 1:
            raise ValueError("polish_sweeps must be >= 1")
        if self.polish_passes < 1:
            raise ValueError("polish_passes must be >= 1")
        if self.schedule not in ("early_exit", "fixed"):
            raise ValueError(f"schedule must be 'early_exit' or 'fixed', got {self.schedule}")
        if self.scaling < 0:
            raise ValueError(f"scaling must be >= 0, got {self.scaling}")
        if self.acceleration not in ("none", "anderson"):
            raise ValueError(
                f"acceleration must be 'none' or 'anderson', got {self.acceleration}"
            )
        if self.anderson_memory <= 0:
            raise ValueError(
                f"anderson_memory must be > 0, got {self.anderson_memory}"
            )
        if not (self.eps_pinf > 0 and self.eps_dinf > 0):
            raise ValueError("eps_pinf/eps_dinf must be > 0")


@dataclasses.dataclass(frozen=True)
class QPState:
    """Warm-startable ADMM iterate, batch-first: x (B, n), z and y (B, m)."""

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor

    @staticmethod
    def zeros(batch: int, n: int, m: int, dtype=torch.float32, device=None) -> "QPState":
        """Zeros on ``device``, by default the card."""
        device = resolve_device(device)
        return QPState(
            x=torch.zeros((batch, n), dtype=dtype, device=device),
            z=torch.zeros((batch, m), dtype=dtype, device=device),
            y=torch.zeros((batch, m), dtype=dtype, device=device),
        )


@dataclasses.dataclass(frozen=True)
class QPInfo:
    """Solve diagnostics, each (B,)."""

    status: torch.Tensor  # int32 QPStatus code
    iter: torch.Tensor  # int32
    rho_updates: torch.Tensor  # int32
    rho_estimate: torch.Tensor
    res_prim: torch.Tensor
    res_dual: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QPResult:
    """Solution, diagnostics and the warm start for the next solve."""

    x: torch.Tensor  # (B, n) primal solution
    y: torch.Tensor  # (B, m) dual solution
    z: torch.Tensor  # (B, m) auxiliary solution (= Ax at convergence)
    info: QPInfo

    @property
    def state(self) -> QPState:
        return QPState(x=self.x, z=self.z, y=self.y)
