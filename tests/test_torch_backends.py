"""The linear-solver backends (``ops/linear_solver.py``) against the JAX
package, float64.

Each of ``kkt_ldlt``, ``cg``, ``schur_cholesky_tri``,
``schur_cholesky_blocked`` and ``schur_block_tridiag``: its factor, solve
(with and without refinement), ``solve_xz`` and ``is_failure`` against the
JAX backend (written per problem, lifted with ``jax.vmap``) on a batch
that mixes healthy, NaN and indefinite problems; then the per-problem tier
``qp_solve_batch(impl="vmap")`` on each backend against JAX's (statuses,
iteration and rho-update counts equal, x, y, z to atol 1e-9), the fused
tier's structured route with and without Anderson against the JAX fused
tier, and the failure cases of the JAX package's
``tests/test_qp.py::TestLinearSolverHardening``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.mpc import mpc_qp_stagewise_batch as jax_stagewise
from sqp_solver_tpu.ops import linear_solver as jls
from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.admm_batched import qp_solve_fused as jax_qp_solve_fused
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models.families import huber_qp_batch
from sqp_solver_tpu_torch.ops import linear_solver as pls
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp import qp_solve
from sqp_solver_tpu_torch.qp.admm_batched import qp_solve_fused
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus, QuadraticProblem
from sqp_solver_tpu_torch.testing import btd_qp_inputs, qp_inputs

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
BACKENDS = ("kkt_ldlt", "cg", "schur_cholesky_tri", "schur_cholesky_blocked",
            "schur_block_tridiag")


def _operands(name):
    """(P, A, rho) of five problems: three healthy, one with a NaN in P and
    one with an indefinite P; a band structure of block 4 for the
    block-tridiagonal backend."""
    if name == "schur_block_tridiag":
        a = btd_qp_inputs(5, 3, 4, 9, seed=21)
    else:
        a = qp_inputs(5, 6, 8, seed=21, loose_row=True, equality_row=True)
    P, A = a["P"].copy(), a["A"]
    P[3, 0, 0] = np.nan
    P[4] = -P[4]
    rho = np.random.default_rng(21).uniform(0.05, 5.0, size=A.shape[:2])
    return P, A, rho


def _solvers(name):
    bs = 4 if name == "schur_block_tridiag" else 0
    return jls.get_linear_solver(name, block_size=bs), pls.get_linear_solver(name, bs)


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_matches_jax(name):
    P, A, rho = _operands(name)
    js, ps = _solvers(name)
    sigma = 1e-6
    jf = jax.vmap(js.factor, in_axes=(0, 0, None, 0))(jnp.asarray(P), jnp.asarray(A), sigma,
                                                      jnp.asarray(rho))
    pf = ps.factor(torch.as_tensor(P), torch.as_tensor(A), sigma, torch.as_tensor(rho))
    assert set(pf) == set(jf)
    fail = np.asarray(jax.vmap(js.is_failure)(jf))
    np.testing.assert_array_equal(ps.is_failure(pf).numpy(), fail)
    assert not fail[:3].any() and fail[3]
    good = slice(0, 3)
    for k, v in pf.items():
        np.testing.assert_allclose(v.numpy()[good], np.asarray(jf[k])[good], atol=1e-12,
                                   rtol=1e-12, err_msg=k)
    rng = np.random.default_rng(22)
    rhs1, rhs2 = rng.normal(size=P.shape[:2]), rng.normal(size=A.shape[:2])
    args = [jnp.asarray(v) for v in (P, A)] + [sigma] + [jnp.asarray(v) for v in
                                                         (rho, rhs1, rhs2)]
    targs = [torch.as_tensor(v) for v in (P, A)] + [sigma] + [torch.as_tensor(v) for v in
                                                              (rho, rhs1, rhs2)]
    axes = (0, 0, 0, None, 0, 0, 0, None)
    for steps in (0, 2):
        want = jax.vmap(js.solve, in_axes=axes)(jf, *args, steps)
        got = ps.solve(pf, *targs, steps)
        np.testing.assert_allclose(got.numpy()[good], np.asarray(want)[good], atol=ATOL,
                                   rtol=0)
        wxz = jax.vmap(js.solve_xz, in_axes=axes)(jf, *args, steps)
        gxz = ps.solve_xz(pf, *targs, steps)
        for g, w in zip(gxz, wxz):
            np.testing.assert_allclose(g.numpy()[good], np.asarray(w)[good], atol=ATOL,
                                       rtol=0)
    # the solve is a solve of the Schur system M x = rhs1 + A' (rho .* rhs2)
    Pt, At, rt = (torch.as_tensor(v) for v in (P, A, rho))
    M = Pt + sigma * torch.eye(P.shape[-1], dtype=Pt.dtype) + At.mT @ (rt[..., None] * At)
    b = torch.as_tensor(rhs1) + (rt * torch.as_tensor(rhs2)).unsqueeze(-2).matmul(At).squeeze(-2)
    x = ps.solve(pf, *targs, 0)
    resid = (M @ x.unsqueeze(-1)).squeeze(-1) - b
    assert resid[good].abs().max() < 1e-8


def test_blocked_pieces_match_jax():
    """The blocked Cholesky and triangular inverse at panels of 4 on n = 10
    (a partial last panel) against the JAX pieces."""
    rng = np.random.default_rng(0)
    G = rng.normal(size=(2, 10, 10))
    M = G @ G.transpose(0, 2, 1) + 10 * np.eye(10)
    Lj = jax.vmap(lambda m: jls._blocked_cholesky(m, bs=4))(jnp.asarray(M))
    L = pls._blocked_cholesky(torch.as_tensor(M), bs=4)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), atol=1e-12)
    Lij = jax.vmap(lambda m: jls._blocked_tri_inv(m, bs=4))(Lj)
    np.testing.assert_allclose(pls._blocked_tri_inv(L, bs=4).numpy(), np.asarray(Lij),
                               atol=1e-12)


def _vmap_case(name):
    if name == "schur_block_tridiag":
        jq, b = jax_stagewise(4, horizon=4, seed=3, dtype=jnp.float64)
        a = {k: np.array(getattr(jq, k)) for k in LEAVES}
        return a, dict(block_size=b)
    return qp_inputs(4, 6, 8, seed=23, loose_row=True), {}


@pytest.mark.parametrize("name", BACKENDS)
def test_vmap_tier_backend_matches_jax(name):
    """The per-problem tier on each backend, adaptive rho and two
    refinement steps, against the JAX per-problem tier."""
    a, extra = _vmap_case(name)
    s = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=400, check_termination=10,
             adaptive_rho=True, adaptive_rho_interval=40, refine_steps=2,
             linear_solver=name, **extra)
    jr = jax_qp_solve_batch(JaxQP(*(jnp.asarray(a[k]) for k in LEAVES)), JaxQPSettings(**s),
                            impl="vmap")
    pr = qp_solve_batch(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"),
                        QPSettings(**s), impl="vmap")
    p = interop.qp_result_to_numpy(pr)
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(p[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k], np.asarray(getattr(jr, k)), atol=ATOL, rtol=0,
                                   err_msg=k)
    assert (p["status"] == QPStatus.SOLVED).all()


@pytest.mark.parametrize("variant", ["fixed", "anderson"])
def test_fused_structured_route_matches_jax(variant):
    """The fused tier with ``schur_block_tridiag`` (JAX
    tests/test_structured.py:283-321's shapes), fixed schedule with
    adaptive rho, or Anderson without it."""
    jq, b = jax_stagewise(3, horizon=8, dtype=jnp.float64)
    if variant == "fixed":
        s = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=500, adaptive_rho=True,
                 schedule="fixed")
    else:
        s = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=2000, adaptive_rho=False,
                 acceleration="anderson")
    s.update(linear_solver="schur_block_tridiag", block_size=b)
    jr = jax_qp_solve_fused(jq, JaxQPSettings(**s))
    pq = QuadraticProblem(*(torch.as_tensor(np.array(getattr(jq, k))) for k in LEAVES))
    pr = qp_solve_fused(pq, QPSettings(**s))
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(pr, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=ATOL, rtol=0, err_msg=k)
    assert (pr.info.status == QPStatus.SOLVED).all()
    if variant == "anderson":
        plain = qp_solve_fused(pq, QPSettings(**dict(s, acceleration="none")))
        assert pr.info.iter.double().mean() <= plain.info.iter.double().mean()


def _simple_qp(nan=False):
    P = torch.tensor([[4.0, 1.0], [1.0, 2.0]], dtype=torch.float64)
    if nan:
        P[0, 0] = float("nan")
    return QuadraticProblem(
        P=P, q=torch.tensor([1.0, 1.0], dtype=torch.float64),
        A=torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]], dtype=torch.float64),
        l=torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64),
        u=torch.tensor([1.0, 0.7, 0.7], dtype=torch.float64))


@pytest.mark.parametrize("name", ["cg", "kkt_ldlt"])
def test_nan_input_is_never_solved(name):
    """JAX tests/test_qp.py:262-269 and 283-289: a NaN in P reports
    NUMERICAL_ISSUES on kkt_ldlt and is never SOLVED on cg; the clean
    problem solves to x* = (0.3, 0.7)."""
    bad = qp_solve(_simple_qp(nan=True), QPSettings(linear_solver=name))
    if name == "kkt_ldlt":
        assert int(bad.info.status) == QPStatus.NUMERICAL_ISSUES
    else:
        assert int(bad.info.status) != QPStatus.SOLVED
    good = qp_solve(_simple_qp(), QPSettings(linear_solver=name))
    assert int(good.info.status) == QPStatus.SOLVED
    np.testing.assert_allclose(good.x.numpy(), [0.3, 0.7], atol=1e-2)


def test_cg_ill_conditioned_converges():
    """JAX tests/test_qp.py:223-240: a wide rho spread (equality and loose
    rows) under the Jacobi preconditioner."""
    rng = np.random.default_rng(7)
    n, m = 12, 16
    G = rng.normal(size=(n, n))
    P = G @ G.T + np.diag(10.0 ** rng.uniform(-3, 3, n))
    A = rng.normal(size=(m, n))
    Ax = A @ rng.normal(size=n)
    l = np.where(np.arange(m) % 3 == 0, Ax, Ax - 1.0)
    u = np.where(np.arange(m) % 3 == 0, Ax, Ax + 1.0)
    qp = QuadraticProblem(*(torch.as_tensor(v) for v in (P, rng.normal(size=n), A, l, u)))
    ref = qp_solve(qp, QPSettings(adaptive_rho=True, max_iter=4000))
    res = qp_solve(qp, QPSettings(adaptive_rho=True, max_iter=4000, linear_solver="cg"))
    assert int(res.info.status) == QPStatus.SOLVED
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), atol=1e-2)


def test_kkt_pivot_threshold():
    """JAX tests/test_qp.py:271-282: the floor is absolute, so pivots that
    span [sigma, rho_max] are healthy."""
    floor = torch.tensor([5e-7])
    for d, failed in (([2.0, 1.0, -0.5, -3.0], False), ([2.0, 1e-20, -0.5, -3.0], True),
                      ([2.0, float("nan"), -0.5, -3.0], True), ([1e-6, 3e6, -0.5, -3.0], False)):
        f = pls._kkt_is_failure({"d": torch.tensor([d]), "pivot_floor": floor})
        assert bool(f[0]) == failed, d


def test_kkt_ldlt_solves_equality_heavy_f32():
    """JAX tests/test_qp.py:284-296: the huber family in float32 under
    scaling is never reported NUMERICAL_ISSUES by the pivot floor."""
    problem, _ = huber_qp_batch(2, dtype=torch.float32, device="cpu")
    res = qp_solve_batch(problem, QPSettings(eps_abs=1e-3, eps_rel=1e-3, max_iter=500,
                                             adaptive_rho=True, linear_solver="kkt_ldlt",
                                             scaling=10))
    assert (res.info.status != QPStatus.NUMERICAL_ISSUES).all(), res.info.status
