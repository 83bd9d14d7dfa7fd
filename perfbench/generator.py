"""Inputs of the benchmark, drawn on the device.

One general generator: a configuration file names its problem class
(``"problem_class"``) and its sizes; a traffic mix file gives the batch,
the number of distinct batches in the pool, the seed of its batches and
how the entry is called; the run's seed orders the batches
(:func:`make_pool`).
The problems are made here, never by the program under test, so that the
reference can judge the program's answers against inputs that it knows.

The OSQP benchmark's Control class (Stellato et al. 2020,
arXiv 1711.08013, section 7; the osqp_benchmarks ``problem_classes``),
one random instance a problem: dynamics x_{t+1} = A x_t + B u_t with
A = I + Delta, Delta_ij ~ N(0, 0.01), B_ij ~ N(0, 1); stage cost
x'Qx + u'Ru with Q = diag(q), q_i ~ U(0, 10) on a random 70 % of the states
(0 on the rest), R = 0.1 I; the terminal cost the LQR one (the discrete
Riccati equation of A, B, Q, R); boxes |x_t| <= xbar, xbar_i ~ U(1, 2),
|u_t| <= ubar, ubar_i ~ U(0, 0.1); x_0 ~ U(-xbar / 2, xbar / 2), halved
until a rollout of the LQR law clipped to the input box stays in the state
box, so that every instance has a feasible point (about half of the
class's draws are infeasible otherwise).  Stage-wise layout
z = [(u_0, x_1), ..., (u_{T-1}, x_T)] (block nx + nu, n = (nx + nu) T);
rows: the dynamics equalities (nx T, x_0 entering the first through its
bounds), the input box (nu T), the state box (nx T).  q = 0.
"""

from __future__ import annotations

import torch

__all__ = ["control_params", "control_batch", "make_pool", "problem_shape"]


def problem_shape(cfg: dict) -> tuple:
    """(n, m) of one problem of the configuration."""
    nx, nu, T = cfg["nx"], cfg["nu"], cfg["horizon"]
    return (nx + nu) * T, (2 * nx + nu) * T


def _dare(A, B, Q, R, iters: int = 2000, tol: float = 1e-10, check: int = 25):
    """The discrete algebraic Riccati equation's solution of each problem by
    the Riccati iteration from Q in Joseph's form, X = Q + K'RK + (A - BK)'
    X (A - BK), K = (R + B'XB)^-1 B'XA, until no entry moves by more than
    ``tol`` of the largest (checked every ``check`` iterations)."""
    X = Q.clone()
    Bt = B.mT
    for k in range(iters):
        K = torch.linalg.solve(R + Bt @ X @ B, Bt @ X @ A)
        Acl = A - B @ K
        Xn = Q + K.mT @ R @ K + Acl.mT @ X @ Acl
        Xn = 0.5 * (Xn + Xn.mT)
        if (k + 1) % check == 0:
            if float((Xn - X).abs().amax()) <= tol * max(1.0, float(Xn.abs().amax())):
                return Xn
        X = Xn
    return X


def control_params(cfg: dict, count: int, gen: torch.Generator, device) -> dict:
    """The class's parameters of ``count`` problems in float64, drawn with
    ``gen`` in a few calls over all of them: the plant (Ad, Bd), the cost
    (qd, R, QT), the boxes (xbar, ubar), the initial state x0 and the LQR
    rollout that shows each instance feasible (``feasible``)."""
    nx, nu, T = cfg["nx"], cfg["nu"], cfg["horizon"]
    f64 = dict(dtype=torch.float64, device=device)

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f64)

    eye = torch.eye(nx, **f64)
    Ad = eye + 0.1 * torch.randn((count, nx, nx), generator=gen, **f64)
    Bd = torch.randn((count, nx, nu), generator=gen, **f64)
    qd = uniform(0.0, 10.0, (count, nx)) * (uniform(0.0, 1.0, (count, nx)) < 0.7)
    Q = torch.diag_embed(qd)
    R = (0.1 * torch.eye(nu, **f64)).expand(count, nu, nu).contiguous()
    QT = _dare(Ad, Bd, Q, R)
    xbar = uniform(1.0, 2.0, (count, nx))
    ubar = uniform(0.0, 0.1, (count, nu))
    x0 = uniform(-0.5, 0.5, (count, nx)) * xbar
    Bt = Bd.mT
    K = torch.linalg.solve(R + Bt @ QT @ Bd, Bt @ QT @ Ad)
    for _ in range(60):
        x, ok = x0, torch.ones(count, dtype=torch.bool, device=device)
        for _k in range(T):
            uk = torch.clamp(-(K @ x.unsqueeze(-1)).squeeze(-1), -ubar, ubar)
            x = (Ad @ x.unsqueeze(-1)).squeeze(-1) + (Bd @ uk.unsqueeze(-1)).squeeze(-1)
            ok &= (x.abs() <= xbar).all(-1)
        if bool(ok.all()):
            break
        x0 = torch.where(ok.unsqueeze(-1), x0, 0.5 * x0)
    return dict(Ad=Ad, Bd=Bd, qd=qd, R=R, QT=QT, xbar=xbar, ubar=ubar, x0=x0, feasible=ok)


def control_batch(cfg: dict, params: dict, sel, dtype=torch.float32) -> dict:
    """The dense QP (P, q, A, l, u) of the problems ``sel`` (an index
    tensor) of ``params`` in the stage-wise layout, in ``dtype``,
    contiguous."""
    nx, nu, T = cfg["nx"], cfg["nu"], cfg["horizon"]
    Ad, Bd, qd, R, QT = (params[k][sel] for k in ("Ad", "Bd", "qd", "R", "QT"))
    xbar, ubar, x0 = (params[k][sel] for k in ("xbar", "ubar", "x0"))
    batch, dev = Ad.shape[0], Ad.device
    b = nx + nu
    n, m = problem_shape(cfg)
    opts = dict(dtype=dtype, device=dev)
    P = torch.zeros((batch, n, n), **opts)
    A = torch.zeros((batch, m, n), **opts)
    l = torch.zeros((batch, m), **opts)
    u = torch.zeros((batch, m), **opts)
    eye_x = torch.eye(nx, **opts)
    eye_u = torch.eye(nu, **opts)
    Q = torch.diag_embed(qd).to(dtype)
    for k in range(T):
        o = b * k
        P[:, o:o + nu, o:o + nu] = R.to(dtype)
        P[:, o + nu:o + b, o + nu:o + b] = QT.to(dtype) if k == T - 1 else Q
        r = nx * k  # x_{k+1} - A x_k - B u_k = 0 (A x_0 on the right for k = 0)
        A[:, r:r + nx, o:o + nu] = -Bd.to(dtype)
        A[:, r:r + nx, o + nu:o + b] = eye_x
        if k > 0:
            A[:, r:r + nx, o - nx:o] = -Ad.to(dtype)
        r = nx * T + nu * k
        A[:, r:r + nu, o:o + nu] = eye_u
        l[:, r:r + nu], u[:, r:r + nu] = -ubar.to(dtype), ubar.to(dtype)
        r = (nx + nu) * T + nx * k
        A[:, r:r + nx, o + nu:o + b] = eye_x
        l[:, r:r + nx], u[:, r:r + nx] = -xbar.to(dtype), xbar.to(dtype)
    ax0 = (Ad @ x0.unsqueeze(-1)).squeeze(-1).to(dtype)
    l[:, :nx] = ax0
    u[:, :nx] = ax0
    return dict(P=P, q=torch.zeros((batch, n), **opts), A=A, l=l, u=u,
                feasible=params["feasible"][sel])


CLASSES = {"control": (control_params, control_batch)}


def make_pool(cfg: dict, mix: dict, seed: int, device) -> list:
    """``mix["pool_batches"]`` batches of ``mix["batch"]`` problems of the
    configuration's class on ``device``.  The batches are drawn from the
    mix's fixed ``set_seed`` with one ``torch.Generator`` there (the
    parameters of all of them in one pass); the run's ``seed`` orders them.
    So every seed sends the same work in its own order (the same seed, the
    same pool): how many problems of a batch run long is the data's, and a
    seed that drew its own problems would change the work, not its order."""
    draw, assemble = CLASSES[cfg["problem_class"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mix["set_seed"]))
    batch, count = mix["batch"], mix["batch"] * mix["pool_batches"]
    params = draw(cfg, count, gen, device)
    gen.manual_seed(int(seed))
    order = torch.randperm(mix["pool_batches"], generator=gen, device=device).tolist()
    idx = torch.arange(count, device=device)
    return [assemble(cfg, params, idx[k * batch:(k + 1) * batch]) for k in order]
