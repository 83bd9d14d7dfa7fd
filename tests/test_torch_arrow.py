"""The ``schur_arrow`` backend and the coupled MPC family against the JAX
package, float64.

* ``mpc_qp_coupled_batch`` draws from ``np.random.default_rng(seed)`` in the
  JAX package's order: the same arrays.
* The arrow factor (batch-first here, per problem and lifted by
  ``jax.vmap`` there) against JAX's on healthy, NaN and indefinite
  problems.
* ``qp_solve_batch`` with ``schur_arrow`` on the vmap and fused tiers
  against the JAX package's (its ``tests/test_structured.py::TestArrow``
  shapes and settings): equal statuses and counts, x and y to 1e-9; then
  arrow against the dense backend in the port, the rendezvous rows after
  polish, and the validation errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.mpc import mpc_qp_coupled_batch as jax_coupled
from sqp_solver_tpu.ops import linear_solver as jls
from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu_torch.models.mpc import mpc_qp_coupled_batch
from sqp_solver_tpu_torch.ops import linear_solver as pls
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
SHAPE = dict(agents=6, horizon=4, meet_points=2)  # TestArrow._problem


def _pair(batch=4, **kw):
    shape = dict(SHAPE, **kw)
    jq, b, c = jax_coupled(batch, dtype=jnp.float64, **shape)
    pq, b2, c2 = mpc_qp_coupled_batch(batch, dtype=torch.float64, device="cpu", **shape)
    assert (b, c) == (b2, c2)
    return jq, pq, b, c


@pytest.mark.parametrize("shape", [dict(), dict(agents=3, horizon=5, meet_points=3, seed=4)])
def test_coupled_family_equals_jax(shape):
    jq, pq, b, c = _pair(3, **shape)
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(pq, k).numpy(), np.asarray(getattr(jq, k)),
                                      err_msg=k)
    assert (b, c) == (shape.get("horizon", 4), shape.get("meet_points", 2))
    # the Schur matrix has no coupling between two agents' blocks
    M = pls._schur_matrix(pq.P, pq.A, 1e-6, torch.full(pq.l.shape, 0.1, dtype=torch.float64))
    T = (M.shape[-1] - c) // b
    for i in range(T):
        for j in range(T):
            if i != j:
                assert M[:, i * b:(i + 1) * b, j * b:(j + 1) * b].abs().max() == 0.0


def test_arrow_factor_matches_jax():
    jq, pq, b, c = _pair(5)
    P = pq.P.numpy().copy()
    P[3, 0, 0] = np.nan  # a NaN and an indefinite block fail, the others not
    P[4, :b, :b] = -P[4, :b, :b] - 10.0 * np.eye(b)
    rho = np.random.default_rng(5).uniform(0.05, 5.0, size=pq.l.shape)
    js = jls.get_linear_solver("schur_arrow", b, c)
    ps = pls.get_linear_solver("schur_arrow", b, c)
    jf = jax.vmap(js.factor, in_axes=(0, 0, None, 0))(jnp.asarray(P), jq.A, 1e-6,
                                                      jnp.asarray(rho))
    pf = ps.factor(torch.as_tensor(P), pq.A, 1e-6, torch.as_tensor(rho))
    assert set(pf) == set(jf)
    fail = np.asarray(jax.vmap(js.is_failure)(jf))
    np.testing.assert_array_equal(ps.is_failure(pf).numpy(), fail)
    np.testing.assert_array_equal(pf["diag_nan"].numpy(), np.asarray(jf["diag_nan"]))
    assert not fail[:3].any() and fail[3:].all()
    for k in ("W", "Minv", "M"):
        np.testing.assert_allclose(pf[k].numpy()[:3], np.asarray(jf[k])[:3], atol=1e-10,
                                   rtol=0, err_msg=k)
    # the explicit inverse is M's, and the solves agree with JAX's
    eye = np.eye(P.shape[-1])
    np.testing.assert_allclose(pf["Minv"].numpy()[:3] @ pf["M"].numpy()[:3], np.broadcast_to(
        eye, (3,) + eye.shape), atol=1e-10)
    rng = np.random.default_rng(6)
    rhs1, rhs2 = rng.normal(size=pq.q.shape), rng.normal(size=pq.l.shape)
    for refine in (0, 1):
        jx, jz = jax.vmap(lambda f, A_, r_, a, b_: js.solve_xz(f, None, A_, 1e-6, r_, a, b_,
                                                                 refine))(
            jf, jq.A, jnp.asarray(rho), jnp.asarray(rhs1), jnp.asarray(rhs2))
        px, pz = ps.solve_xz(pf, None, pq.A, 1e-6, torch.as_tensor(rho), torch.as_tensor(rhs1),
                             torch.as_tensor(rhs2), refine)
        np.testing.assert_allclose(px.numpy()[:3], np.asarray(jx)[:3], atol=1e-10, rtol=0)
        np.testing.assert_allclose(pz.numpy()[:3], np.asarray(jz)[:3], atol=1e-10, rtol=0)


@pytest.mark.parametrize("impl,tight", [("vmap", False), ("fused", True)])
def test_arrow_solve_matches_jax(impl, tight):
    """TestArrow.test_matches_dense_path's settings on the vmap tier and
    test_fused_arrow_matches_vmap's on the fused one."""
    jq, pq, b, c = _pair()
    kw = dict(adaptive_rho=True, max_iter=2000, linear_solver="schur_arrow", block_size=b,
              arrow_width=c)
    if tight:
        kw.update(eps_abs=1e-8, eps_rel=1e-8)
    jr = jax_qp_solve_batch(jq, JaxQPSettings(**kw), impl=impl)
    pr = qp_solve_batch(pq, QPSettings(**kw), impl=impl)
    np.testing.assert_array_equal(pr.info.status.numpy(), np.asarray(jr.info.status))
    assert (pr.info.status == QPStatus.SOLVED).all()
    for k in ("iter", "rho_updates"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(pr, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_arrow_matches_dense_backend_and_rendezvous():
    """Arrow against the dense default in the port (the same iterate math:
    equal counts), then the rendezvous rows after polish (TestArrow's
    rendezvous semantics)."""
    _, pq, b, c = _pair()
    dense = qp_solve_batch(pq, QPSettings(adaptive_rho=True, max_iter=2000))
    arrow_s = QPSettings(adaptive_rho=True, max_iter=2000, linear_solver="schur_arrow",
                         block_size=b, arrow_width=c)
    arrow = qp_solve_batch(pq, arrow_s)
    assert (arrow.info.status == QPStatus.SOLVED).all()
    np.testing.assert_array_equal(arrow.info.iter.numpy(), dense.info.iter.numpy())
    np.testing.assert_allclose(arrow.x.numpy(), dense.x.numpy(), atol=1e-9)
    res = qp_solve_batch(pq, dataclasses.replace(arrow_s, eps_abs=1e-8, eps_rel=1e-8,
                                                 max_iter=4000, polish=True))
    assert (res.info.status == QPStatus.SOLVED).all()
    viol = torch.einsum("bmn,bn->bm", pq.A, res.x) - pq.u
    eq_rows = [k * (2 * b + 1) + 2 * b for k in range(SHAPE["agents"])]
    assert viol[:, eq_rows].abs().max() < 1e-6


def test_arrow_validation():
    for bs, aw in ((4, 0), (0, 2), (-1, 1)):
        with pytest.raises(ValueError, match="schur_arrow"):
            pls.get_linear_solver("schur_arrow", block_size=bs, arrow_width=aw)
    with pytest.raises(ValueError):
        QPSettings(linear_solver="schur_arrow", block_size=4).validate()
    with pytest.raises(ValueError):
        QPSettings(linear_solver="schur_arrow", arrow_width=2).validate()
    with pytest.raises(ValueError, match="block_size"):
        pls.get_linear_solver("schur_block_tridiag")
