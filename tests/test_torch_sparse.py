"""BlockSparse operands on the matrix-free ``cg`` backend against the JAX
package, float64 (its ``tests/test_sparse.py`` and
``tests/test_structured.py::TestReferenceSparsePort``).

* ``ops/block_sparse.py``: the round trip, ``mv``, ``rmv``, ``diag`` and
  the scaled Gram product against dense numpy and JAX's BlockSparse, with
  and without a batch axis on the tiles; prepared strips against
  unprepared ones, bit for bit.
* ``sparse_qp_pair`` draws the JAX package's problem; ``cg`` carries the
  strips from its factor step; the sparse solve equals JAX's sparse solve
  and the port's dense one (status and counts, x to 1e-9); warm start;
  the gates; the certificates on BlockSparse operands.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.problems import simple_qp as jax_simple_qp
from sqp_solver_tpu.models.sparse import sparse_qp_pair as jax_sparse_qp_pair
from sqp_solver_tpu.ops import block_sparse as jbs
from sqp_solver_tpu.qp import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp import qp_solve as jax_qp_solve
from sqp_solver_tpu.qp.infeasibility import infeasibility_certificates as jax_certificates
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch.models.problems import SIMPLE_QP_SOLUTION, simple_qp
from sqp_solver_tpu_torch.models.sparse import sparse_qp_pair
from sqp_solver_tpu_torch.ops.block_sparse import BlockSparse, from_dense, to_dense
from sqp_solver_tpu_torch.ops.linear_solver import get_linear_solver
from sqp_solver_tpu_torch.qp import QPSettings, QPStatus, QuadraticProblem, qp_solve
from sqp_solver_tpu_torch.qp.infeasibility import infeasibility_certificates

CG = dict(linear_solver="cg", eps_abs=1e-7, eps_rel=1e-7, max_iter=2000, check_termination=25,
          adaptive_rho=True)
RTOL = 1e-12


def _mat(seed=0, shape=(96, 64), bs=32):
    rng = np.random.default_rng(seed)
    M = np.zeros(shape)
    for i in range(shape[0] // bs):
        for j in range(shape[1] // bs):
            if rng.uniform() < 0.4 or i == j:
                M[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.normal(size=(bs, bs))
    return M


def _pair(n, bs, density, seed):
    jd, js = jax_sparse_qp_pair(n=n, m=n, bs=bs, density=density, seed=seed, dtype=jnp.float64)
    pd, ps = sparse_qp_pair(n=n, m=n, bs=bs, density=density, seed=seed, dtype=torch.float64,
                            device="cpu")
    return jd, js, pd, ps


def test_roundtrip_products_and_jax():
    M = _mat()
    S = from_dense(M, bs=32, device="cpu")
    J = jbs.from_dense(M, bs=32)
    assert (S.rows, S.cols, S.shape) == (J.rows, J.cols, J.shape)
    np.testing.assert_array_equal(S.data.numpy(), np.asarray(J.data))
    np.testing.assert_array_equal(to_dense(S).numpy(), M)
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=M.shape[1]), rng.normal(size=M.shape[0])
    for got, want, jax_got in ((S.mv(torch.as_tensor(x)), M @ x, J.mv(jnp.asarray(x))),
                               (S.rmv(torch.as_tensor(y)), M.T @ y, J.rmv(jnp.asarray(y)))):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=RTOL, atol=1e-12)


def test_diag_gram_and_batched_tiles():
    M = _mat(seed=3, shape=(64, 64))
    S = from_dense(M, bs=32, device="cpu")
    np.testing.assert_array_equal(S.diag().numpy(), np.diag(M))
    rng = np.random.default_rng(4)
    w, x = np.abs(rng.normal(size=64)) + 0.1, rng.normal(size=64)
    np.testing.assert_allclose(S.scaled_gram_mv(torch.as_tensor(w), torch.as_tensor(x)).numpy(),
                               M.T @ (w * (M @ x)), rtol=RTOL, atol=1e-12)
    # a batch of three matrices on the same pattern, and shared tiles
    # against a batch of vectors
    scale = np.array([1.0, -2.0, 0.5])
    Sb = S.with_data(S.data.unsqueeze(0) * torch.as_tensor(scale)[:, None, None, None])
    X = rng.normal(size=(3, 64))
    want = scale[:, None] * (X @ M.T)
    np.testing.assert_allclose(Sb.mv(torch.as_tensor(X)).numpy(), want, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(S.mv(torch.as_tensor(X)).numpy(), X @ M.T, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(Sb.diag().numpy(), scale[:, None] * np.diag(M), rtol=RTOL)
    np.testing.assert_array_equal(Sb[1:].data.numpy(), Sb.data.numpy()[1:])
    np.testing.assert_array_equal(to_dense(Sb).numpy()[2], 0.5 * M)
    assert Sb._plans is S._plans  # the pattern's plans are shared
    with pytest.raises(ValueError, match="multiple"):
        from_dense(np.zeros((40, 64)), bs=32, device="cpu")
    assert from_dense(np.ones((40, 64)), bs=32, pad=True, device="cpu").shape == (64, 64)


def test_prepared_matches_unprepared():
    rng = np.random.default_rng(9)
    bs = 32
    M = np.zeros((96, 64))
    for i, j in ((0, 0), (0, 1), (1, 1), (2, 0)):
        M[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.normal(size=(bs, bs))
    S = from_dense(M, bs=bs, device="cpu")
    x, y = torch.as_tensor(rng.normal(size=64)), torch.as_tensor(rng.normal(size=96))
    assert torch.equal(S.mv(x, prepared=S.prepare(False)), S.mv(x))
    assert torch.equal(S.rmv(y, prepared=S.prepare(True)), S.rmv(y))
    np.testing.assert_allclose(S.mv(x).numpy(), M @ x.numpy(), rtol=RTOL, atol=1e-12)


def test_cg_factor_carries_strips():
    jd, js, pd, ps = _pair(128, 32, 0.4, 2)
    solver = get_linear_solver("cg")
    rho = torch.full((1, 128), 0.1, dtype=torch.float64)
    lift = lambda S: S.with_data(S.data.unsqueeze(0))  # noqa: E731
    Pb, Ab = lift(ps.P), lift(ps.A)
    fac = solver.factor(Pb, Ab, 1e-6, rho)
    assert {"P_mv", "A_mv", "A_rmv"} <= set(fac)
    fac_d = solver.factor(pd.P[None], pd.A[None], 1e-6, rho)
    np.testing.assert_allclose(fac["jacobi"].numpy(), fac_d["jacobi"].numpy(), rtol=RTOL)
    rng = np.random.default_rng(3)
    rhs1, rhs2 = (torch.as_tensor(rng.normal(size=(1, 128))) for _ in range(2))
    xs = solver.solve(fac, Pb, Ab, 1e-6, rho, rhs1, rhs2, 0)
    xd = solver.solve(fac_d, pd.P[None], pd.A[None], 1e-6, rho, rhs1, rhs2, 0)
    np.testing.assert_allclose(xs.numpy(), xd.numpy(), atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("n,bs,density,seed", [(256, 64, 0.15, 7), (128, 32, 0.3, 8)])
def test_sparse_solve_matches_jax_and_dense(n, bs, density, seed):
    jd, js, pd, ps = _pair(n, bs, density, seed)
    for k in ("P", "A"):
        S, J = getattr(ps, k), getattr(js, k)
        assert (S.rows, S.cols) == (J.rows, J.cols)
        np.testing.assert_array_equal(S.data.numpy(), np.asarray(J.data))
    for k in ("q", "l", "u"):
        np.testing.assert_array_equal(getattr(pd, k).numpy(), np.asarray(getattr(jd, k)))
    jr = jax_qp_solve(js, JaxQPSettings(**CG))
    pr = qp_solve(ps, QPSettings(**CG))
    dr = qp_solve(pd, QPSettings(**CG))
    for r in (pr, dr):
        assert int(r.info.status) == int(jr.info.status) == QPStatus.SOLVED
        assert int(r.info.iter) == int(jr.info.iter)
        assert int(r.info.rho_updates) == int(jr.info.rho_updates)
        np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), atol=1e-9, rtol=0)
        np.testing.assert_allclose(r.y.numpy(), np.asarray(jr.y), atol=1e-9, rtol=0)
    # a warm start from the solution takes no more iterations
    again = qp_solve(ps, QPSettings(**CG), state=pr.state)
    assert int(again.info.iter) <= int(pr.info.iter)
    assert int(again.info.status) == QPStatus.SOLVED


def test_sparse_gates_raise():
    _, sparse = sparse_qp_pair(n=128, m=128, bs=32, density=0.3, seed=10, dtype=torch.float64,
                               device="cpu")
    with pytest.raises(ValueError, match="matrix-free"):
        qp_solve(sparse, QPSettings(**dict(CG, linear_solver="schur_cholesky")))
    for kw in ({"polish": True}, {"scaling": 10}):
        with pytest.raises(ValueError, match="BlockSparse"):
            qp_solve(sparse, QPSettings(**dict(CG, **kw)))


def test_sparse_certificates_match_jax():
    """Contradictory duplicate equality rows: the dual delta along them is
    a primal certificate, through BlockSparse P and A, as in JAX; random
    deltas are not; and the solve of that problem ends as JAX's does."""
    jd, js, pd, ps = _pair(128, 32, 0.3, 12)
    A = to_dense(ps.A).numpy().copy()
    A[1] = A[0]
    l, u = pd.l.numpy().copy(), pd.u.numpy().copy()
    l[0] = u[0]
    l[1] = u[1] = u[0] + 1.0
    bad = QuadraticProblem(P=ps.P, q=ps.q, A=from_dense(A, 32, device="cpu"),
                           l=torch.as_tensor(l), u=torch.as_tensor(u))
    jbad = JaxQP(P=js.P, q=js.q, A=jbs.from_dense(A, 32), l=jnp.asarray(l), u=jnp.asarray(u))
    rng = np.random.default_rng(13)
    dy = np.zeros((3, 128))
    dy[0, 0], dy[0, 1] = 1.0, -1.0
    dy[1:] = rng.normal(size=(2, 128))
    dx = rng.normal(size=(3, 128))
    for i in range(3):
        args = (dx[i], dy[i], 1e-4, 1e-4)
        prim, dual = infeasibility_certificates(bad.P, bad.A, bad.q, bad.l, bad.u,
                                                *(torch.as_tensor(a) for a in args[:2]),
                                                *args[2:])
        jprim, jdual = jax_certificates(jbad.P, jbad.A, jbad.q, jbad.l, jbad.u,
                                        *(jnp.asarray(a) for a in args[:2]), *args[2:])
        assert (bool(prim), bool(dual)) == (bool(jprim), bool(jdual))
        assert bool(prim) == (i == 0)
    s = dict(CG, max_iter=300)
    jr = jax_qp_solve(jbad, JaxQPSettings(**s))
    pr = qp_solve(bad, QPSettings(**s))
    assert int(pr.info.status) == int(jr.info.status)
    assert int(pr.info.status) in (QPStatus.PRIMAL_INFEASIBLE, QPStatus.MAX_ITER_EXCEEDED)
    assert int(pr.info.iter) == int(jr.info.iter)


def test_reference_sparse_port():
    """JAX tests/test_structured.py::TestReferenceSparsePort: the reference's
    disabled sparse tests (qp_solver_sparse_test.cpp:51-98) on cg."""
    qp = simple_qp(device="cpu")
    res = qp_solve(qp, QPSettings(linear_solver="cg"))
    jres = jax_qp_solve(jax_simple_qp(), JaxQPSettings(linear_solver="cg"))
    assert int(res.info.status) == int(jres.info.status) == QPStatus.SOLVED
    assert int(res.info.iter) == int(jres.info.iter)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-9)
    np.testing.assert_allclose(res.x.numpy(), SIMPLE_QP_SOLUTION, atol=1e-2)
    # a repeated solve gives the same iterate (testSolveRepeat)
    again = qp_solve(qp, QPSettings(linear_solver="cg"))
    assert torch.equal(again.x, res.x)
    # new P and q with the same structure (testCanUpdateQP)
    qp2 = dataclasses.replace(qp, P=2.0 * qp.P, q=torch.tensor([1.0, -1.0], dtype=torch.float64))
    res2 = qp_solve(qp2, QPSettings(linear_solver="cg", eps_abs=1e-5, eps_rel=1e-5,
                                    max_iter=4000))
    assert int(res2.info.status) == QPStatus.SOLVED
    assert not torch.allclose(res.x, res2.x)
    Ax = qp2.A @ res2.x
    assert (Ax - qp2.l).min() > -1e-3 and (Ax - qp2.u).max() < 1e-3
    # a BlockSparse operand with no batch axis cannot be indexed
    with pytest.raises(IndexError):
        from_dense(np.eye(32), bs=32, device="cpu")[0]
    assert isinstance(from_dense(torch.eye(32, dtype=torch.float64), bs=32), BlockSparse)
