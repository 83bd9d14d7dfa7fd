"""Batched QP families for the QP serving path (twin of the condensed-MPC
and random-QP part of ``sqp_solver_tpu/models/mpc.py``).

* :func:`mpc_qp_batch`: condensed receding-horizon MPC of a double
  integrator, one shared (P, A) and per-instance (q, l, u) from the batch
  of initial states;
* :func:`random_qp_batch`: random strictly convex QPs with feasible bounds;
* :func:`mpc_fleet`: the same MPC as a receding-horizon fleet, the QP
  rebuilt from the plant state at every control step (the sustained-MPC
  leg of the JAX package's ``bench.py:854-901``).

Both MPC forms build their QP with the same two helpers: the shared
matrices from :func:`_mpc_operators`, the per-state vectors from
:func:`_mpc_vectors` (numpy for the batch, tensors on the device for the
fleet).  The data are built in float64 numpy with the same calls in the same order
as the JAX package, so one seed gives the identical problem in both, then
cast and moved to ``device`` (by default the card).
"""

from __future__ import annotations

import numpy as np
import torch

from sqp_solver_tpu_torch.qp.types import QuadraticProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = ["mpc_qp_batch", "random_qp_batch", "mpc_fleet", "double_integrator_condensed"]


def double_integrator_condensed(horizon: int, dt: float = 0.1):
    """Condensed pos/vel double-integrator dynamics over ``horizon`` steps:
    ``(Sx, Su)`` with state_k = Sx[k] @ x0 + Su[k] @ u."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    nx = 2
    Sx = np.zeros((horizon, nx, nx))
    Su = np.zeros((horizon, nx, horizon))
    Ak = np.eye(nx)
    for k in range(horizon):
        Ak = A @ Ak
        Sx[k] = Ak
        for j in range(k + 1):
            Su[k][:, j] = (np.linalg.matrix_power(A, k - j) @ B)[:, 0]
    return Sx, Su


def _mpc_operators(horizon: int, dt: float, r_weight: float):
    """The condensed MPC's state-independent parts, float64 numpy: the
    shared P and A, and the maps from the plant state to the positions
    (Sp_x, Sp_u) and velocities (Sv_x) over the horizon."""
    Sx, Su = double_integrator_condensed(horizon, dt)
    Sp_x, Sp_u = Sx[:, 0, :], Su[:, 0, :]
    Sv_x, Sv_u = Sx[:, 1, :], Su[:, 1, :]
    P = Sp_u.T @ Sp_u + r_weight * np.eye(horizon)
    A_mat = np.concatenate([np.eye(horizon), Sv_u], axis=0)
    return P, A_mat, Sp_x, Sp_u, Sv_x


def _mpc_vectors(x0, Sp_x, Sp_u, Sv_x, u_max: float, v_max: float):
    """(q, l, u) of the condensed MPC QP at the plant states ``x0`` (B, 2),
    for numpy arrays and tensors alike: position tracking to the origin,
    |u| <= u_max and |vel| <= v_max."""
    q = (x0 @ Sp_x.T) @ Sp_u
    vel_off = x0 @ Sv_x.T
    if torch.is_tensor(x0):
        cat, box = torch.cat, torch.full_like(vel_off, u_max)
    else:
        cat, box = np.concatenate, np.full_like(vel_off, u_max)
    return q, cat([-box, -v_max - vel_off], 1), cat([box, v_max - vel_off], 1)


def _problem(P, q, A, l, u, dtype, device) -> QuadraticProblem:
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    return QuadraticProblem(P=t(P), q=t(q), A=t(A), l=t(l), u=t(u))


def mpc_qp_batch(
    batch: int,
    horizon: int = 16,
    dt: float = 0.1,
    u_max: float = 2.0,
    v_max: float = 1.5,
    r_weight: float = 0.1,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
) -> QuadraticProblem:
    """Condensed MPC QP batch (n = horizon, m = 2 horizon): position
    tracking to the origin plus input effort, |u| <= u_max and
    |vel| <= v_max.  The batch varies the initial state."""
    P, A_mat, Sp_x, Sp_u, Sv_x = _mpc_operators(horizon, dt, r_weight)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(batch, 2))
    q, l, u = _mpc_vectors(x0, Sp_x, Sp_u, Sv_x, u_max, v_max)
    return _problem(
        np.broadcast_to(P, (batch, horizon, horizon)), q,
        np.broadcast_to(A_mat, (batch, 2 * horizon, horizon)), l, u, dtype, device,
    )


def random_qp_batch(
    batch: int,
    n: int = 32,
    m: int = 48,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
) -> QuadraticProblem:
    """Batch of random strictly convex QPs with feasible bounds."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.1 * np.eye(n)
    q = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m, n)) / np.sqrt(n)
    x_feas = rng.normal(size=(batch, n))
    Ax = np.einsum("bmn,bn->bm", A, x_feas)
    width = rng.uniform(0.1, 2.0, size=(batch, m))
    return _problem(P, q, A, Ax - width, Ax + width, dtype, device)


def mpc_fleet(
    batch: int,
    horizon: int = 16,
    dt: float = 0.1,
    u_max: float = 2.0,
    v_max: float = 1.5,
    r_weight: float = 0.1,
    dtype=torch.float32,
    device=None,
):
    """A fleet of ``batch`` double-integrator plants under condensed MPC.

    Returns ``(make_qp, step)``: ``make_qp(state)`` builds the batch's QP
    (as :func:`mpc_qp_batch`, shared P and A moved to the device once) at
    the plant states ``state`` (B, 2) = (position, velocity);
    ``step(state, u0)`` applies the first inputs ``u0`` (B,) for one
    period ``dt``."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    P, A, Sp_x, Sp_u, Sv_x = (t(a) for a in _mpc_operators(horizon, dt, r_weight))
    P = P.expand(batch, horizon, horizon).contiguous()
    A = A.expand(batch, 2 * horizon, horizon).contiguous()
    Ad, Bd = t([[1.0, dt], [0.0, 1.0]]), t([0.5 * dt * dt, dt])

    def make_qp(state):
        q, l, u = _mpc_vectors(state, Sp_x, Sp_u, Sv_x, u_max, v_max)
        return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)

    def step(state, u0):
        return state @ Ad.T + u0.unsqueeze(-1) * Bd

    return make_qp, step
