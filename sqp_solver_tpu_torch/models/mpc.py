"""Batched QP and NLP families for the serving and structured paths (twin
of ``sqp_solver_tpu/models/mpc.py``).

* :func:`mpc_qp_batch`: condensed receding-horizon MPC of a double
  integrator, one shared (P, A) and per-instance (q, l, u) from the batch
  of initial states;
* :func:`random_qp_batch`: random strictly convex QPs with feasible bounds;
* :func:`mpc_fleet`: the same MPC as a receding-horizon fleet, the QP
  rebuilt from the plant state at every control step (the sustained-MPC
  leg of the JAX package's ``bench.py:854-901``);
* :func:`mpc_qp_stagewise_batch`: the non-condensed (stage-wise) MPC QP,
  whose Schur matrix is block-tridiagonal at block size 3;
* :func:`mpc_nlp_stagewise_batch`: the stage-wise nonlinear MPC of a
  unicycle, block-tridiagonal at block size 4, with its independent
  float64 certificate :func:`mpc_nlp_kkt_residuals`;
* :func:`mpc_qp_coupled_batch`: multi-agent rendezvous MPC, whose Schur
  matrix is arrow-structured (one block per agent, bordered by the shared
  meet points).

Both condensed MPC forms build their QP with the same two helpers: the shared
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
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = [
    "mpc_qp_batch",
    "random_qp_batch",
    "mpc_fleet",
    "double_integrator_condensed",
    "mpc_qp_stagewise_batch",
    "mpc_qp_coupled_batch",
    "mpc_nlp_stagewise_batch",
    "mpc_nlp_stagewise_problem",
    "mpc_nlp_kkt_residuals",
]


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


def mpc_qp_stagewise_batch(
    batch: int,
    horizon: int = 16,
    dt: float = 0.1,
    u_max: float = 2.0,
    v_max: float = 1.5,
    p_max: float = 5.0,
    q_weight=(1.0, 0.1),
    r_weight: float = 0.1,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
):
    """Stage-wise (non-condensed) MPC QP of a double integrator, with a
    block-tridiagonal Schur matrix.

    Decision variable z = [(u_0, x_1), ..., (u_{T-1}, x_T)] in stage blocks
    of nu + nx = 3; block-diagonal cost; rows: the dynamics equalities
    (2 T, x_0 entering the first through its bounds), the input box (T)
    and the state box (2 T).  Every row touches at most two adjacent
    blocks, so M = P + sigma I + A' rho A is block-tridiagonal at block
    size 3: solve with ``QPSettings(linear_solver="schur_block_tridiag",
    block_size=3)``.  Returns ``(problem, block_size)``."""
    nx, nu = 2, 1
    b = nx + nu
    T = horizon
    n = b * T
    Ad = np.array([[1.0, dt], [0.0, 1.0]])
    Bd = np.array([[0.5 * dt * dt], [dt]])
    Q = np.diag(q_weight)
    P = np.zeros((n, n))
    for k in range(T):
        o = b * k
        P[o : o + nu, o : o + nu] = r_weight * np.eye(nu)
        P[o + nu : o + b, o + nu : o + b] = Q
    m = nx * T + nu * T + nx * T
    A_mat = np.zeros((m, n))
    r = 0
    for k in range(T):
        o = b * k
        A_mat[r : r + nx, o : o + nu] = -Bd
        A_mat[r : r + nx, o + nu : o + b] = np.eye(nx)
        if k > 0:
            o_prev = b * (k - 1)
            A_mat[r : r + nx, o_prev + nu : o_prev + b] = -Ad
        r += nx
    for k in range(T):
        A_mat[r, b * k] = 1.0
        r += 1
    for k in range(T):
        o = b * k + nu
        A_mat[r : r + nx, o : o + nx] = np.eye(nx)
        r += nx

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(batch, nx))
    rhs0 = x0 @ Ad.T
    l = np.zeros((batch, m))
    u = np.zeros((batch, m))
    l[:, :nx] = rhs0
    u[:, :nx] = rhs0
    l[:, nx * T : nx * T + T] = -u_max
    u[:, nx * T : nx * T + T] = u_max
    l[:, nx * T + T :] = np.tile([-p_max, -v_max], T)
    u[:, nx * T + T :] = np.tile([p_max, v_max], T)
    problem = _problem(np.broadcast_to(P, (batch, n, n)), np.zeros((batch, n)),
                       np.broadcast_to(A_mat, (batch, m, n)), l, u, dtype, device)
    return problem, b


def mpc_qp_coupled_batch(
    batch: int,
    agents: int = 8,
    horizon: int = 4,
    meet_points: int = 2,
    dt: float = 0.25,
    u_max: float = 2.0,
    v_max: float = 1.5,
    p_max: float = 5.0,
    r_weight: float = 0.1,
    w_weight: float = 1e-2,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
):
    """Multi-agent rendezvous MPC with an arrow-structured Schur matrix.

    ``agents`` double integrators each plan a condensed input sequence of
    ``horizon`` inputs (tracking and effort cost, input box, velocity
    rows), and agent k's terminal position must equal a shared, jointly
    optimised rendezvous coordinate w_{k mod meet_points} (one equality row
    on that agent's inputs and w).  No row couples two agents, so
    M = P + sigma I + A' rho A is block diagonal (a block of ``horizon``
    per agent) bordered by ``meet_points`` dense columns: solve with
    ``QPSettings(linear_solver="schur_arrow", block_size=horizon,
    arrow_width=meet_points)``.  P and A are shared by the batch; the
    initial states enter through q and the rendezvous bounds.  Returns
    ``(problem, block_size, arrow_width)``."""
    h, S, c = horizon, agents, meet_points
    n = S * h + c
    Sx, Su = double_integrator_condensed(h, dt)
    Sp_x, Sp_u = Sx[:, 0, :], Su[:, 0, :]
    Sv_x, Sv_u = Sx[:, 1, :], Su[:, 1, :]
    P_blk = Sp_u.T @ Sp_u + r_weight * np.eye(h)
    P = np.zeros((n, n))
    for k in range(S):
        o = h * k
        P[o:o + h, o:o + h] = P_blk
    P[S * h:, S * h:] = w_weight * np.eye(c)

    # rows per agent: input box (h), velocity bounds (h), rendezvous (1);
    # then the box of w (c)
    m = S * (2 * h + 1) + c
    A_mat = np.zeros((m, n))
    r = 0
    for k in range(S):
        o = h * k
        A_mat[r:r + h, o:o + h] = np.eye(h)
        r += h
        A_mat[r:r + h, o:o + h] = Sv_u
        r += h
        A_mat[r, o:o + h] = Sp_u[h - 1]
        A_mat[r, S * h + (k % c)] = -1.0
        r += 1
    A_mat[r:r + c, S * h:] = np.eye(c)

    rng = np.random.default_rng(seed)
    # initial states tight enough that the agents sharing a meet point can
    # always reach a common terminal position: every instance is feasible
    x0 = rng.uniform(-0.3, 0.3, size=(batch, S, 2))
    q = np.zeros((batch, n))
    q[:, :S * h] = np.einsum("bsx,hx,hj->bsj", x0, Sp_x, Sp_u).reshape(batch, S * h)
    pos_off = np.einsum("bsx,x->bs", x0, Sp_x[h - 1])
    vel_off = np.einsum("bsx,hx->bsh", x0, Sv_x)
    l = np.zeros((batch, m))
    u = np.zeros((batch, m))
    for k in range(S):
        r0 = k * (2 * h + 1)
        l[:, r0:r0 + h] = -u_max
        u[:, r0:r0 + h] = u_max
        l[:, r0 + h:r0 + 2 * h] = -v_max - vel_off[:, k]
        u[:, r0 + h:r0 + 2 * h] = v_max - vel_off[:, k]
        l[:, r0 + 2 * h] = -pos_off[:, k]
        u[:, r0 + 2 * h] = -pos_off[:, k]
    l[:, S * (2 * h + 1):] = -p_max
    u[:, S * (2 * h + 1):] = p_max
    problem = _problem(np.broadcast_to(P, (batch, n, n)), q,
                       np.broadcast_to(A_mat, (batch, m, n)), l, u, dtype, device)
    return problem, h, c


def mpc_nlp_stagewise_problem(l, u, params, horizon: int, dt: float = 0.1,
                              speed: float = 1.0, q_weight: float = 1.0,
                              r_weight: float = 0.1, th_weight: float = 0.01
                              ) -> NonlinearProblem:
    """The unicycle family's problem from its data: bounds ``l``, ``u``
    (B, 7 T) and ``params`` (B, 5) = (x_0 (3), goal (2)).  Objective and
    constraint are batched torch functions of z (B, 4 T) that ``torch.func``
    differentiates."""
    T, b, v = horizon, 4, speed

    def objective(z, p):
        Z = z.reshape(z.shape[0], T, b)
        X = Z[..., 1:]
        pos = X[..., :2] - p[:, None, 3:5]
        return 0.5 * (
            q_weight * (pos * pos).sum((-2, -1))
            + r_weight * (Z[..., 0] * Z[..., 0]).sum(-1)
            + th_weight * (X[..., 2] * X[..., 2]).sum(-1)
        )

    def constraint(z, p):
        Z = z.reshape(z.shape[0], T, b)
        u_ = Z[..., 0]
        X = Z[..., 1:]
        Xprev = torch.cat([p[:, None, :3], X[:, :-1]], dim=1)
        th = Xprev[..., 2]
        step = torch.stack([v * torch.cos(th), v * torch.sin(th), u_], dim=-1)
        dyn = (X - Xprev - dt * step).reshape(z.shape[0], -1)
        return torch.cat([dyn, u_, X.reshape(z.shape[0], -1)], dim=-1)

    return NonlinearProblem(l=l, u=u, params=params, objective=objective,
                            constraint=constraint)


def mpc_nlp_stagewise_batch(
    batch: int,
    horizon: int = 48,
    dt: float = 0.1,
    speed: float = 1.0,
    omega_max: float = 2.0,
    p_max: float = 5.0,
    theta_max: float = 4.0,
    q_weight: float = 1.0,
    r_weight: float = 0.1,
    th_weight: float = 0.01,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
):
    """Stage-wise nonlinear MPC batch: a unicycle (state (px, py, theta),
    turn-rate control, constant speed) steered to a per-problem goal.
    Decision variable z = [(u_0, x_1), ..., (u_{T-1}, x_T)] in stage blocks
    of 4; x_0 and the goal enter through ``params``.  Rows (m = 7 T): the
    dynamics equalities (3 T, nonlinear in theta), the turn-rate box (T)
    and the state box (3 T).  Every Schur matrix B + sigma I + J' rho J is
    block-tridiagonal at block size 4: solve with
    ``SQPSettings(qp_impl="kernel_btd", qp=QPSettings(block_size=4, ...))``.

    Returns ``(problem, x_init, block_size)`` with ``x_init`` (B, 4 T) the
    dynamically feasible zero-control rollout."""
    nx, nu = 3, 1
    b = nx + nu
    T = horizon
    n = b * T
    v = speed
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(batch, nx))
    goal = rng.uniform(-2.0, 2.0, size=(batch, 2))
    params = np.concatenate([x0, goal], axis=1)
    m = 3 * T + T + 3 * T
    l = np.zeros((batch, m))
    u = np.zeros((batch, m))
    l[:, 3 * T : 4 * T] = -omega_max
    u[:, 3 * T : 4 * T] = omega_max
    l[:, 4 * T :] = np.tile([-p_max, -p_max, -theta_max], T)
    u[:, 4 * T :] = np.tile([p_max, p_max, theta_max], T)
    X_init = np.zeros((batch, T, b))
    xk = x0.copy()
    for k in range(T):
        xk = xk + dt * np.stack(
            [v * np.cos(xk[:, 2]), v * np.sin(xk[:, 2]), np.zeros(batch)], axis=1
        )
        X_init[:, k, 1:] = xk
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    problem = mpc_nlp_stagewise_problem(
        t(l), t(u), t(params), horizon, dt=dt, speed=speed, q_weight=q_weight,
        r_weight=r_weight, th_weight=th_weight)
    return problem, t(X_init.reshape(batch, n)), b


def _f64(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def mpc_nlp_kkt_residuals(problem, x, lam, horizon, dt=0.1, speed=1.0,
                          q_weight=1.0, r_weight=0.1, th_weight=0.01):
    """Float64 KKT residuals of :func:`mpc_nlp_stagewise_batch`, in numpy
    with the hand-derived unicycle Jacobian and no solver code on the path:
    ``(primal_viol, dual_res)`` per problem.  Pass the generator's weights
    through where they were changed."""
    T = horizon
    b = 4
    x = _f64(x)
    lam = _f64(lam)
    p = _f64(problem.params)
    B = x.shape[0]
    x0_, goal = p[:, :3], p[:, 3:5]
    v = speed

    Z = x.reshape(B, T, b)
    u_ = Z[:, :, 0]
    X = Z[:, :, 1:]
    Xprev = np.concatenate([x0_[:, None, :], X[:, :-1]], axis=1)
    th_prev = Xprev[:, :, 2]

    g = np.zeros_like(Z)
    g[:, :, 0] = r_weight * u_
    g[:, :, 1:3] = q_weight * (X[:, :, :2] - goal[:, None, :])
    g[:, :, 3] = th_weight * X[:, :, 2]

    lam_d = lam[:, : 3 * T].reshape(B, T, 3)
    lam_u = lam[:, 3 * T : 4 * T]
    lam_x = lam[:, 4 * T :].reshape(B, T, 3)

    s = g.copy()
    # dynamics row k: +I on x_{k+1}, -I - dt D_k on x_k (a decision
    # variable for k >= 1), -dt e3 on u_k; D_k has only a theta column
    s[:, :, 1:] += lam_d + lam_x
    s[:, :, 0] += -dt * lam_d[:, :, 2] + lam_u
    contrib = -lam_d[:, 1:, :].copy()
    contrib[:, :, 2] -= dt * v * (
        -np.sin(th_prev[:, 1:]) * lam_d[:, 1:, 0]
        + np.cos(th_prev[:, 1:]) * lam_d[:, 1:, 1]
    )
    s[:, :-1, 1:] += contrib
    dual_res = np.abs(s.reshape(B, -1)).max(axis=1)

    step = np.stack([v * np.cos(th_prev), v * np.sin(th_prev), u_], axis=2)
    dyn = X - Xprev - dt * step
    cv = np.concatenate([dyn.reshape(B, -1), u_, X.reshape(B, -1)], axis=1)
    lo = np.broadcast_to(_f64(problem.l), cv.shape)
    hi = np.broadcast_to(_f64(problem.u), cv.shape)
    primal_viol = np.maximum(np.maximum(cv - hi, lo - cv), 0.0).max(axis=1)
    return primal_viol, dual_res
