"""Seeded numpy inputs for the port's kernels, batch-first.

The tests and ``chip_smoke.py`` feed the same arrays to a kernel and to
its plain version (and, in the CPU tests, to the JAX kernel), so the
inputs are made with numpy rather than a framework's generator.  Each
batch mixes the cases the kernels branch on.
"""

from __future__ import annotations

import numpy as np

__all__ = ["step_inputs", "polish_inputs", "qp_inputs", "certificate_qp_inputs",
           "spd_inputs", "admm_chunk_inputs", "btd_qp_inputs", "btd_route_inputs",
           "btd_step_inputs", "control_qp_inputs"]


def step_inputs(batch: int, n: int, m: int, seed: int = 0, dtype=np.float64,
                equality_row: bool = True) -> dict:
    """Operands of one SQP-step kernel call: an SPD Hessian estimate, a
    random Jacobian and feasible bounds with one loose row and (with
    ``equality_row``) one equality row per problem, a BFGS pair (s, dgl),
    the masks and a warm start.  The main path's subproblems have no
    equality rows; an equality row's multiplier integrates the residual
    with rho_eq = 1e3 rho, which amplifies float32 rounding in y ~100x.

    Problem 0 resets its Hessian, problem 1 (and every third after it) has
    negative curvature (damped update), problem 2 skips the update,
    problem 3 carries an indefinite Hessian into the posdef fallback, and
    the last problem is inactive."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((batch, n, n)) / np.sqrt(n)
    Bm = G @ G.transpose(0, 2, 1) + 0.5 * np.eye(n)
    J = rng.standard_normal((batch, m, n)) / np.sqrt(n)
    g = rng.standard_normal((batch, n))
    # bounds around J p0 keep every QP feasible
    center = np.einsum("bmn,bn->bm", J, 0.3 * rng.standard_normal((batch, n)))
    width = rng.uniform(0.1, 1.0, (batch, m))
    l, u = center - width, center + width
    if equality_row:
        l[:, 0] = u[:, 0] = center[:, 0]
    l[:, -1], u[:, -1] = -1e20, 1e20
    s = 0.1 * rng.standard_normal((batch, n))
    dgl = np.einsum("bij,bj->bi", Bm, s) + 0.05 * rng.standard_normal((batch, n))
    dgl[1::3] *= -0.5
    reset = np.zeros(batch, bool)
    upd = np.ones(batch, bool)
    active = np.ones(batch, bool)
    reset[0] = True
    if batch > 2:
        upd[2] = False
    if batch > 4:
        Bm[3] = -np.eye(n)
        upd[3] = False
        active[-1] = False
    x = 0.1 * rng.standard_normal((batch, n))
    z = np.clip(0.1 * rng.standard_normal((batch, m)), l, u)
    y = 0.1 * rng.standard_normal((batch, m))
    out = dict(B=Bm, J=J, g=g, l=l, u=u, s=s, dgl=dgl, x=x, z=z, y=y)
    out = {k: v.astype(dtype) for k, v in out.items()}
    out.update(reset=reset, upd=upd, active=active)
    return out


def polish_inputs(batch: int, n: int, m: int, seed: int = 0, dtype=np.float64) -> dict:
    """Operands of one polish-KKT kernel call: an SPD Lagrangian Hessian
    (indefinite on problem 0 when batch > 2, to raise the fail flag), a
    random Jacobian, about half the rows active, targets on the active
    rows, a multiplier warm start and a primal warm start x0."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((batch, n, n)) / np.sqrt(n)
    H = G @ G.transpose(0, 2, 1) + 0.5 * np.eye(n)
    if batch > 2:
        H[0] = -np.eye(n)
    J = rng.standard_normal((batch, m, n)) / np.sqrt(n)
    act = rng.uniform(size=(batch, m)) < 0.5
    r1 = rng.standard_normal((batch, n))
    b = np.where(act, rng.standard_normal((batch, m)), 0.0)
    nu0 = 0.1 * rng.standard_normal((batch, m))
    x0 = 0.1 * rng.standard_normal((batch, n))
    out = dict(H=H, J=J, r1=r1, b=b, nu0=nu0, x0=x0)
    out = {k: v.astype(dtype) for k, v in out.items()}
    out["act"] = act
    return out


def qp_inputs(batch: int, n: int, m: int, seed: int = 0, dtype=np.float64,
              equality_row: bool = False, loose_row: bool = False) -> dict:
    """One whole-QP kernel call's operands: random strictly convex QPs with
    feasible bounds (``models.mpc.random_qp_batch``'s construction), with
    optionally an equality row (row 0) and a loose row (the last), and a
    warm start (x, z, y) near zero."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n)) / np.sqrt(n)
    P = np.einsum("bij,bkj->bik", M, M) + 0.1 * np.eye(n)
    q = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m, n)) / np.sqrt(n)
    Ax = np.einsum("bmn,bn->bm", A, rng.normal(size=(batch, n)))
    width = rng.uniform(0.1, 2.0, size=(batch, m))
    l, u = Ax - width, Ax + width
    if equality_row:
        l[:, 0] = u[:, 0] = Ax[:, 0]
    if loose_row:
        l[:, -1], u[:, -1] = -1e20, 1e20
    x = 0.1 * rng.standard_normal((batch, n))
    z = np.clip(0.1 * rng.standard_normal((batch, m)), l, u)
    y = 0.1 * rng.standard_normal((batch, m))
    out = dict(P=P, q=q, A=A, l=l, u=u, x=x, z=z, y=y)
    return {k: v.astype(dtype) for k, v in out.items()}


def certificate_qp_inputs(batch: int, n: int, seed: int = 0, dtype=np.float64) -> dict:
    """A batch of QPs with m = n + 2 rows that cycles feasible, primal
    infeasible and dual infeasible problems (in that order, problem i of
    kind i % 3), for the infeasibility certificates.

    * primal infeasible: rows 0 and 1 are the same vector a with
      a'x <= -1 (row 0, lower bound loose) and a'x >= 1 (row 1, upper
      bound loose);
    * dual infeasible: P is PSD with a null direction d, q'd < 0, every
      row but the last is orthogonal to d and the last row is d itself
      with d'x >= 0 (upper bound loose): the objective falls without
      bound along d.
    """
    m = n + 2
    base = qp_inputs(batch, n, m, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed + 1)
    P, q, A, l, u = (base[k] for k in ("P", "q", "A", "l", "u"))
    for i in range(batch):
        kind = i % 3
        if kind == 1:
            a = rng.normal(size=n) / np.sqrt(n)
            A[i, 0] = A[i, 1] = a
            l[i, 0], u[i, 0] = -1e30, -1.0
            l[i, 1], u[i, 1] = 1.0, 1e30
        elif kind == 2:
            d = rng.normal(size=n)
            d /= np.linalg.norm(d)
            proj = np.eye(n) - np.outer(d, d)
            G = rng.normal(size=(n, n)) / np.sqrt(n)
            P[i] = proj @ (G @ G.T + 0.1 * np.eye(n)) @ proj
            q[i] = proj @ q[i] - 1.0 * d
            A[i, :-1] = A[i, :-1] @ proj
            A[i, -1] = d
            x_feas = rng.normal(size=n)
            Ax = A[i, :-1] @ x_feas
            w = rng.uniform(0.1, 2.0, size=m - 1)
            l[i, :-1], u[i, :-1] = Ax - w, Ax + w
            l[i, -1], u[i, -1] = 0.0, 1e30
    out = dict(P=P, q=q, A=A, l=l, u=u)
    zeros = dict(x=np.zeros((batch, n)), z=np.zeros((batch, m)), y=np.zeros((batch, m)))
    out.update(zeros)
    return {k: v.astype(dtype) for k, v in out.items()}


def spd_inputs(batch: int, n: int, seed: int = 0, dtype=np.float64) -> dict:
    """SPD-inverse kernel operands: M = G G' / n + 0.5 I per problem
    (the polish preconditioner's scale), with problem 0 indefinite when
    batch > 2, to raise the fail flag."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((batch, n, n)) / np.sqrt(n)
    M = G @ G.transpose(0, 2, 1) + 0.5 * np.eye(n)
    if batch > 2:
        M[0] = -np.eye(n)
    return dict(M=M.astype(dtype))


def admm_chunk_inputs(batch: int, n: int, m: int, seed: int = 0, dtype=np.float64,
                      rho: float = 0.1, sigma: float = 1e-6, equality_row: bool = False,
                      loose_row: bool = False) -> dict:
    """Operands of one ADMM chunk kernel (K5) call, batch-first: the fused
    operator W of random strictly convex QPs (``qp_inputs``) built in
    float64 from M = P + sigma I + A' diag(rho) A, the padded vectors
    (qv = [q; 0], scale1 = [sigma; rho], rhoip = [0; 1/rho], rhop = [0;
    rho], lp = [-inf; l], up = [+inf; u]) and a state (s = [x; z], yp =
    [0; y]) near zero.  Optionally row 0 is an equality row (rho_eq =
    1e3 rho) and the last row loose (rho = 1e-6), as the fused tier's
    classification gives them; the main path's subproblems have neither."""
    a = qp_inputs(batch, n, m, seed=seed, dtype=np.float64, equality_row=equality_row,
                  loose_row=loose_row)
    P, A = a["P"], a["A"]
    rho_vec = np.full((batch, m), rho)
    if equality_row:
        rho_vec[:, 0] = 1e3 * rho
    if loose_row:
        rho_vec[:, -1] = 1e-6
    M = P + sigma * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho_vec, A)
    Minv = np.linalg.inv(M)
    G2 = Minv @ A.transpose(0, 2, 1)
    W = np.concatenate([np.concatenate([Minv, G2], axis=2),
                        np.concatenate([A @ Minv, A @ G2], axis=2)], axis=1)
    zeros_n = np.zeros((batch, n))
    out = dict(
        W=W, P=P, A=A,
        qv=np.concatenate([a["q"], np.zeros((batch, m))], axis=1),
        scale1=np.concatenate([np.full((batch, n), sigma), rho_vec], axis=1),
        rhoip=np.concatenate([zeros_n, 1.0 / rho_vec], axis=1),
        rhop=np.concatenate([zeros_n, rho_vec], axis=1),
        lp=np.concatenate([np.full((batch, n), -np.inf), a["l"]], axis=1),
        up=np.concatenate([np.full((batch, n), np.inf), a["u"]], axis=1),
        s=np.concatenate([a["x"], a["z"]], axis=1),
        yp=np.concatenate([zeros_n, a["y"]], axis=1),
    )
    return {k: v.astype(dtype) for k, v in out.items()}


def btd_qp_inputs(batch: int, T: int, bb: int, m: int, seed: int = 0, dtype=np.float64,
                  loose_row: bool = False) -> dict:
    """Random strictly convex QPs whose Schur matrix is block-tridiagonal at
    block size ``bb`` (n = T bb): P = G G' / 2 + 0.1 I with G block lower
    bidiagonal, and rows that each touch two adjacent blocks (row r blocks
    r mod (T - 1) and the next), with feasible bounds around A x_feas and
    no equality rows (the float32 kernel and plain version part ways on
    equality rows, ROADMAP Queue 3); optionally a loose last row.  A warm
    start (x, z, y) near zero."""
    rng = np.random.default_rng(seed)
    n = T * bb
    G = np.zeros((batch, n, n))
    for k in range(T):
        o = k * bb
        G[:, o:o + bb, o:o + bb] = rng.normal(size=(batch, bb, bb)) / np.sqrt(bb)
        if k > 0:
            G[:, o:o + bb, o - bb:o] = 0.3 * rng.normal(size=(batch, bb, bb)) / np.sqrt(bb)
    P = 0.5 * G @ G.transpose(0, 2, 1) + 0.1 * np.eye(n)
    A = np.zeros((batch, m, n))
    for r in range(m):
        k = r % max(T - 1, 1)
        w = min(2, T) * bb
        A[:, r, k * bb:k * bb + w] = rng.normal(size=(batch, w)) / np.sqrt(w)
    q = rng.normal(size=(batch, n))
    Ax = np.einsum("bmn,bn->bm", A, rng.normal(size=(batch, n)))
    width = rng.uniform(0.1, 2.0, size=(batch, m))
    l, u = Ax - width, Ax + width
    if loose_row:
        l[:, -1], u[:, -1] = -1e20, 1e20
    x = 0.1 * rng.standard_normal((batch, n))
    z = np.clip(0.1 * rng.standard_normal((batch, m)), l, u)
    y = 0.1 * rng.standard_normal((batch, m))
    out = dict(P=P, q=q, A=A, l=l, u=u, x=x, z=z, y=y)
    return {k: v.astype(dtype) for k, v in out.items()}


def btd_route_inputs(batch: int, T: int, bb: int, m: int, seed: int = 0, dense=(1,),
                     dtype=np.float64, loose_row: bool = False) -> dict:
    """:func:`btd_qp_inputs` in which the first row of each problem in
    ``dense`` also reaches column block T - 1 (one entry of 1e-3, T >= 3):
    a row across more than two consecutive column blocks, so that those
    problems take the wide structured kernel's dense route and the others
    its band rows.  The structured solvers ignore the coupling the row puts
    outside the band, the JAX kernel as the port's."""
    if T < 3:
        raise ValueError("a row across three column blocks needs T >= 3")
    a = btd_qp_inputs(batch, T, bb, m, seed=seed, dtype=np.float64, loose_row=loose_row)
    for b in dense:
        a["A"][b, 0, (T - 1) * bb] = 1e-3
    return {k: v.astype(dtype) for k, v in a.items()}


def btd_step_inputs(batch: int, T: int, bb: int, m: int, seed: int = 0,
                    dtype=np.float64) -> dict:
    """Operands of one structured step kernel (K7) call, batch-first:
    the band pd, pe (B, T, bb, bb) of :func:`btd_qp_inputs`'s P as the
    Hessian estimate, its A as the Jacobian J, q as the gradient g, the
    bounds and a warm start; ``active`` with the last problem inactive
    (batch > 2), and ``rho_in`` (B,) carrying a rho on every second
    problem (0 means none)."""
    a = btd_qp_inputs(batch, T, bb, m, seed=seed, dtype=np.float64)
    Pb = a["P"].reshape(batch, T, bb, T, bb)
    pd = np.stack([Pb[:, k, :, k, :] for k in range(T)], axis=1)
    pe = np.zeros_like(pd)
    for k in range(T - 1):
        pe[:, k] = Pb[:, k + 1, :, k, :]
    rho_in = np.where(np.arange(batch) % 2 == 1, 0.37, 0.0)
    out = dict(pd=pd, pe=pe, J=a["A"], g=a["q"], l=a["l"], u=a["u"], x=a["x"], z=a["z"],
               y=a["y"], rho_in=rho_in)
    out = {k: v.astype(dtype) for k, v in out.items()}
    active = np.ones(batch, bool)
    if batch > 2:
        active[-1] = False
    out["active"] = active
    return out


def _dare(A, B, Q, R, iters: int = 2000, tol: float = 1e-10):
    """Solution of the discrete algebraic Riccati equation of each problem
    (batch-first A, B, Q, R), by the Riccati iteration from Q in Joseph's
    form X = Q + K'RK + (A - BK)' X (A - BK), K = (R + B'XB)^-1 B'XA."""
    X = Q.copy()
    Bt = B.transpose(0, 2, 1)
    for _ in range(iters):
        K = np.linalg.solve(R + Bt @ X @ B, Bt @ X @ A)
        Acl = A - B @ K
        Xn = Q + K.transpose(0, 2, 1) @ R @ K + Acl.transpose(0, 2, 1) @ X @ Acl
        Xn = 0.5 * (Xn + Xn.transpose(0, 2, 1))
        if np.abs(Xn - X).max() <= tol * max(1.0, np.abs(Xn).max()):
            return Xn
        X = Xn
    return X


def control_qp_inputs(batch: int, horizon: int = 20, nx: int = 12, nu: int = 6, seed: int = 0,
                      dtype=np.float64) -> dict:
    """The OSQP benchmark's "Control" problem class (Stellato et al. 2020,
    arXiv 1711.08013, section 7, "Control"), one random instance a
    problem: dynamics x_{t+1} = A x_t + B u_t with A = I + Delta,
    Delta_ij ~ N(0, 0.01), B_ij ~ N(0, 1); stage cost x'Qx + u'Ru with
    Q = diag(q), q_i ~ U(0, 10) on a random 70 % of the states (0 on the
    rest), R = 0.1 I; terminal cost the LQR one (the Riccati equation of
    A, B, Q, R); boxes |x_t| <= xbar, xbar_i ~ U(1, 2), |u_t| <= ubar,
    ubar_i ~ U(0, 0.1); x_0 ~ U(-xbar / 2, xbar / 2), halved until a
    rollout of the LQR law clipped to the input box stays in the state box
    (about half of the draws are infeasible otherwise).  The defaults are
    a 6-DOF arm (12 states, 6 torques) over 20 steps.

    Stage-wise layout z = [(u_0, x_1), ..., (u_{T-1}, x_T)] as
    ``models.mpc.mpc_qp_stagewise_batch``'s (declared block nx + nu,
    n = (nx + nu) T): rows the dynamics equalities (nx T, x_0 entering the
    first through its bounds), the input box (nu T), the state box
    (nx T).  Returns P, q, A, l, u in ``dtype``."""
    rng = np.random.default_rng(seed)
    b, T = nx + nu, horizon
    n, m = b * T, (2 * nx + nu) * T
    Ad = np.eye(nx) + 0.1 * rng.standard_normal((batch, nx, nx))
    Bd = rng.standard_normal((batch, nx, nu))
    qd = rng.uniform(0.0, 10.0, (batch, nx)) * (rng.uniform(size=(batch, nx)) < 0.7)
    Q = qd[:, :, None] * np.eye(nx)
    R = np.broadcast_to(0.1 * np.eye(nu), (batch, nu, nu))
    QT = _dare(Ad, Bd, Q, R)
    xbar = rng.uniform(1.0, 2.0, (batch, nx))
    ubar = rng.uniform(0.0, 0.1, (batch, nu))
    x0 = rng.uniform(-0.5, 0.5, (batch, nx)) * xbar
    # Drawn so, about half of the instances are infeasible at these sizes:
    # x_0 is halved until the LQR law (clipped to the input box) keeps the
    # state in its box over the horizon, so that every instance has a
    # feasible point.
    Bt = Bd.transpose(0, 2, 1)
    K = np.linalg.solve(R + Bt @ QT @ Bd, Bt @ QT @ Ad)
    for _ in range(60):
        x, ok = x0, np.ones(batch, bool)
        for _k in range(horizon):
            uk = np.clip(-np.einsum("bij,bj->bi", K, x), -ubar, ubar)
            x = np.einsum("bij,bj->bi", Ad, x) + np.einsum("bij,bj->bi", Bd, uk)
            ok &= (np.abs(x) <= xbar).all(axis=1)
        if ok.all():
            break
        x0 = np.where(ok[:, None], x0, 0.5 * x0)
    P = np.zeros((batch, n, n), dtype)
    A = np.zeros((batch, m, n), dtype)
    l = np.zeros((batch, m))
    u = np.zeros((batch, m))
    eye = np.eye(nx)
    for k in range(T):
        o = b * k
        P[:, o:o + nu, o:o + nu] = R
        P[:, o + nu:o + b, o + nu:o + b] = QT if k == T - 1 else Q
        r = nx * k  # x_{k+1} - A x_k - B u_k = 0 (A x_0 on the right for k = 0)
        A[:, r:r + nx, o:o + nu] = -Bd
        A[:, r:r + nx, o + nu:o + b] = eye
        if k > 0:
            A[:, r:r + nx, o - nx:o] = -Ad
        r = nx * T + nu * k
        A[:, r:r + nu, o:o + nu] = np.eye(nu)
        l[:, r:r + nu], u[:, r:r + nu] = -ubar, ubar
        r = (nx + nu) * T + nx * k
        A[:, r:r + nx, o + nu:o + b] = eye
        l[:, r:r + nx], u[:, r:r + nx] = -xbar, xbar
    l[:, :nx] = u[:, :nx] = np.einsum("bij,bj->bi", Ad, x0)
    out = dict(q=np.zeros((batch, n)), l=l, u=u)
    out = {k: v.astype(dtype) for k, v in out.items()}
    out.update(P=P, A=A)
    return out
