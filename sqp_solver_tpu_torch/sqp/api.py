"""Stateful ``SQP`` wrapper mirroring the reference class API (twin of
``sqp_solver_tpu/sqp/api.py``, reference ``include/solvers/sqp.hpp:82-115``:
``solve`` / ``primal_solution`` / ``dual_solution`` / ``settings`` /
``info``).  The functional core is
:func:`sqp_solver_tpu_torch.sqp.solver.sqp_solve`, called as it is."""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.sqp.solver import sqp_solve
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPInfo, SQPSettings

__all__ = ["SQP"]


class SQP:
    def __init__(self, settings: Optional[SQPSettings] = None):
        self._settings = settings or SQPSettings()
        self._result = None

    @property
    def settings(self) -> SQPSettings:
        return self._settings

    @settings.setter
    def settings(self, s: SQPSettings) -> None:
        self._settings = s

    def solve(
        self,
        problem: NonlinearProblem,
        x0: Optional[torch.Tensor] = None,
        lam0: Optional[torch.Tensor] = None,
        num_var: Optional[int] = None,
    ):
        """Solve; ``x0=None`` starts from zeros of length ``num_var``
        (reference overload at ``src/sqp.cpp:34``), on the device and
        dtype of ``problem.l``."""
        if x0 is None:
            if num_var is None:
                raise ValueError("x0=None requires num_var")
            x0 = problem.l.new_zeros((num_var,))
        self._result = sqp_solve(problem, x0, lam0, self._settings)
        return self._result

    def primal_solution(self) -> torch.Tensor:
        return self._result.x

    def dual_solution(self) -> torch.Tensor:
        return self._result.lam

    @property
    def info(self) -> SQPInfo:
        return self._result.info
