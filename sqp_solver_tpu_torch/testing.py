"""Seeded numpy inputs for the two kernels, batch-first.

The tests and ``chip_smoke.py`` feed the same arrays to a kernel and to
its plain version (and, in the CPU tests, to the JAX kernel), so the
inputs are made with numpy rather than a framework's generator.  Each
batch mixes the cases the kernels branch on.
"""

from __future__ import annotations

import numpy as np

__all__ = ["step_inputs", "polish_inputs"]


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
