"""Stateful ``QPSolver`` wrapper mirroring the reference class API (twin of
``sqp_solver_tpu/qp/api.py``, reference ``include/solvers/qp.hpp:147-169``:
``setup`` / ``update_qp`` / ``solve`` / ``primal_solution`` /
``dual_solution`` / ``settings`` / ``info``).  The functional core is
:func:`sqp_solver_tpu_torch.qp.admm.qp_solve`, called as it is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sqp_solver_tpu_torch.qp.admm import qp_solve
from sqp_solver_tpu_torch.qp.types import QPInfo, QPSettings, QPState, QPStatus, QuadraticProblem

__all__ = ["QPSolver"]


def _zeros_state(qp: QuadraticProblem) -> QPState:
    """Zero iterates of the problem's shape, dtype and device."""
    batch = qp.q.shape[:-1]
    return QPState(x=qp.q.new_zeros(batch + (qp.n,)), z=qp.l.new_zeros(batch + (qp.m,)),
                   y=qp.l.new_zeros(batch + (qp.m,)))


class QPSolver:
    """The reference ``qp_solver::QPSolver`` workflow.  Unlike the
    reference, ``warm_start`` works as documented: with
    ``settings.warm_start=True`` consecutive ``solve`` calls reuse the
    previous (x, z, y); with False they start from zero (the reference's
    reset is a no-op bug, ``src/qp.cpp:78-82``)."""

    def __init__(self, settings: Optional[QPSettings] = None):
        self._settings = settings or QPSettings()
        self._qp: Optional[QuadraticProblem] = None
        self._state: Optional[QPState] = None
        self._result = None
        self._status = QPStatus.UNINITIALIZED

    @property
    def settings(self) -> QPSettings:
        return self._settings

    @settings.setter
    def settings(self, s: QPSettings) -> None:
        self._settings = s

    def setup(self, qp: QuadraticProblem) -> None:
        """Bind a problem; zero the iterates."""
        self._qp = qp
        self._state = _zeros_state(qp)
        self._status = QPStatus.UNSOLVED
        self._result = None

    def update_qp(self, qp: QuadraticProblem) -> None:
        """Re-bind a problem of the same shape, keeping the iterates
        (reference ``src/qp.cpp:47-62``)."""
        if self._qp is None:
            raise RuntimeError("call setup() first")
        if (qp.n, qp.m) != (self._qp.n, self._qp.m):
            raise ValueError("update_qp requires the same problem dimensions")
        self._qp = qp
        self._status = QPStatus.UNSOLVED

    def solve(self, qp: Optional[QuadraticProblem] = None):
        if qp is not None:
            if self._qp is None or (qp.n, qp.m) != (self._qp.n, self._qp.m):
                self.setup(qp)
            else:
                self._qp = qp
        if self._qp is None:
            raise RuntimeError("call setup() first")
        if self._status == QPStatus.UNINITIALIZED:
            return self._result
        if self._settings.warm_start and self._result is not None:
            state = self._result.state
        else:
            state = _zeros_state(self._qp)
        self._result = qp_solve(self._qp, self._settings, state)
        self._status = QPStatus(int(self._result.info.status.reshape(-1)[0]))
        return self._result

    def primal_solution(self) -> torch.Tensor:
        return self._result.x

    def dual_solution(self) -> torch.Tensor:
        return self._result.y

    @property
    def info(self) -> QPInfo:
        return self._result.info

    @staticmethod
    def constr_type_init(l, u) -> np.ndarray:
        """The row classes of bounds ``l``, ``u`` (reference static method)."""
        from sqp_solver_tpu_torch.qp.classify import constr_type_init

        return constr_type_init(torch.as_tensor(np.asarray(l)),
                                torch.as_tensor(np.asarray(u))).numpy()
