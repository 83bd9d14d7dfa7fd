"""The port's reference-semantics QP tier against the JAX package.

The same numpy inputs, float64, go through the JAX ``qp_solve`` (one
problem at a time, and under ``jax.vmap``) and through the port's
``qp_solve`` (one problem) and ``qp_solve_batch(impl="vmap")`` (the
batch-first masked loop).  Statuses, iteration and rho-update counts must
be equal and x, y, z agree to atol 1e-9; on infeasible problems, whose
iterates run off along the certificate, to atol 1e-9 plus rtol 1e-9.
Also here: the damped BFGS update and the class shims ``QPSolver`` /
``SQP``, mirroring the class tests of ``tests/test_qp.py`` and
``tests/test_sqp.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.qp.admm import qp_solve as jax_qp_solve
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu.sqp.bfgs import bfgs_update as jax_bfgs_update
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models.problems import (
    SIMPLE_NLP_SOLUTION,
    SIMPLE_QP_SOLUTION,
    simple_nlp,
    simple_qp,
    simple_qp_nlp,
)
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp import QPSolver, qp_solve
from sqp_solver_tpu_torch.qp.types import QPSettings, QPState, QPStatus, QuadraticProblem
from sqp_solver_tpu_torch.sqp import SQP, bfgs_update
from sqp_solver_tpu_torch.sqp.types import SQPSettings
from sqp_solver_tpu_torch.testing import certificate_qp_inputs, qp_inputs
from sqp_solver_tpu_torch.utils import host

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
BASE = dict(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=400, check_termination=25)
# each case: (settings over BASE, qp_inputs keywords, warm start, infeasible)
CASES = {
    "rho_epochs": (dict(adaptive_rho=True, adaptive_rho_interval=25, max_iter=300), {},
                   False, False),
    "warm_start": (dict(adaptive_rho=True, adaptive_rho_interval=50), {}, True, False),
    "infeasible": (dict(max_iter=200), None, False, True),
    "polish": (dict(polish=True, eps_abs=1e-4, eps_rel=1e-4), {"loose_row": True}, False,
               False),
    "anderson": (dict(acceleration="anderson", anderson_memory=3), {}, False, False),
    "refine": (dict(refine_steps=2, adaptive_rho=True), {}, True, False),
    "equality_row": (dict(adaptive_rho=True, adaptive_rho_interval=50),
                     {"equality_row": True, "loose_row": True}, False, False),
    "comp_slack": (dict(check_comp_slack=True, max_iter=300), {}, False, False),
}


def _inputs(case):
    _, kw, _, infeasible = CASES[case]
    if infeasible:
        return certificate_qp_inputs(6, 5, seed=4)
    return qp_inputs(4, 6, 8, seed=3, **kw)


def _settings(case):
    return dict(BASE, **CASES[case][0])


def _assert_equal(port, jr, scale_tol=False):
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(port[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(jr, k)), atol=ATOL,
                                   rtol=ATOL if scale_tol else 0, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_qp_solve_one_problem_matches_jax(case):
    """The per-problem entry, problems 0 and 1 each alone, against the JAX
    ``qp_solve`` of that problem."""
    a, s = _inputs(case), _settings(case)
    warm, infeasible = CASES[case][2], CASES[case][3]
    for i in range(2):
        jq = JaxQP(*(jnp.asarray(a[k][i]) for k in LEAVES))
        jst = JaxQPState(*(jnp.asarray(a[k][i]) for k in "xzy")) if warm else None
        jr = jax_qp_solve(jq, JaxQPSettings(**s), jst)
        pq = QuadraticProblem(*(torch.as_tensor(a[k][i]) for k in LEAVES))
        pst = QPState(*(torch.as_tensor(a[k][i]) for k in "xzy")) if warm else None
        pr = qp_solve(pq, QPSettings(**s), pst)
        assert pr.x.shape == (a["q"].shape[1],) and pr.info.status.shape == ()
        port = {k: getattr(pr, k).numpy() for k in "xyz"}
        port.update({k: getattr(pr.info, k).numpy() for k in ("status", "iter", "rho_updates")})
        _assert_equal(port, jr, infeasible)


@pytest.mark.parametrize("case", list(CASES))
def test_qp_solve_batch_vmap_matches_jax_vmap(case):
    """The masked loop on the batch against ``jax.vmap`` of ``qp_solve``."""
    a, s = _inputs(case), _settings(case)
    warm, infeasible = CASES[case][2], CASES[case][3]
    jq = JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))
    js = JaxQPSettings(**s)
    if warm:
        jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy"))
        jr = jax.vmap(lambda p, st: jax_qp_solve(p, js, st))(jq, jst)
    else:
        jr = jax.vmap(lambda p: jax_qp_solve(p, js))(jq)
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu") if warm else None
    before = host.host_checks
    pr = qp_solve_batch(pq, QPSettings(**s), pst)  # impl="vmap", the default
    assert host.host_checks > before
    _assert_equal(interop.qp_result_to_numpy(pr), jr, infeasible)
    if infeasible:  # every kind of problem was met
        assert set(pr.info.status.tolist()) >= {QPStatus.SOLVED, QPStatus.PRIMAL_INFEASIBLE,
                                                QPStatus.DUAL_INFEASIBLE}


def test_failed_factor_marks_its_problem_alone():
    """A NaN in one problem's P fails its factorization: that problem
    reports NUMERICAL_ISSUES, and the others solve exactly as without it."""
    a = qp_inputs(4, 6, 8, seed=3)
    s = QPSettings(**_settings("rho_epochs"))
    clean = qp_solve_batch(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"), s)
    a["P"][2, 0, 0] = np.nan
    res = qp_solve_batch(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"), s)
    assert res.info.status.tolist() == [0, 0, QPStatus.NUMERICAL_ISSUES, 0]
    keep = [0, 1, 3]
    np.testing.assert_array_equal(res.x[keep].numpy(), clean.x[keep].numpy())
    np.testing.assert_array_equal(res.info.iter[keep].numpy(), clean.info.iter[keep].numpy())


def test_linear_solver_registry_matches_jax():
    """``get_linear_solver("schur_cholesky")``: the factor dict {W, Minv, M,
    diag_nan}, the one-matvec and the refined two-op ``solve_xz`` and the
    failure flag against the JAX backend; then the vmap tier on the
    ``kkt_ldlt``, ``cg`` and ``schur_cholesky_tri`` backends against JAX's
    ``qp_solve`` under ``jax.vmap`` (every backend in detail:
    tests/test_torch_backends.py)."""
    from sqp_solver_tpu.ops.linear_solver import get_linear_solver as jax_get
    from sqp_solver_tpu_torch.ops.linear_solver import get_linear_solver

    a = qp_inputs(3, 5, 7, seed=2)
    rho = np.full((3, 7), 0.1)
    rhs1, rhs2 = a["x"] - a["q"], a["z"] - a["y"]
    js, ps = jax_get("schur_cholesky"), get_linear_solver("schur_cholesky")
    jf = js.factor(jnp.asarray(a["P"]), jnp.asarray(a["A"]), 1e-6, jnp.asarray(rho))
    pf = ps.factor(torch.as_tensor(a["P"]), torch.as_tensor(a["A"]), 1e-6, torch.as_tensor(rho))
    assert set(pf) == set(jf)
    for k in ("W", "Minv", "M"):
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(jf[k]), atol=1e-12, err_msg=k)
    for steps in (0, 2):
        jxz = js.solve_xz(jf, None, jnp.asarray(a["A"]), 1e-6, jnp.asarray(rho),
                          jnp.asarray(rhs1), jnp.asarray(rhs2), steps)
        pxz = ps.solve_xz(pf, None, torch.as_tensor(a["A"]), 1e-6, torch.as_tensor(rho),
                          torch.as_tensor(rhs1), torch.as_tensor(rhs2), steps)
        for got, want in zip(pxz, jxz):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    assert not ps.is_failure(pf).any()
    bad = ps.factor(-torch.as_tensor(a["P"]), torch.as_tensor(a["A"]), 1e-6,
                    torch.as_tensor(rho))
    assert ps.is_failure(bad).all()
    for name in ("kkt_ldlt", "cg", "schur_cholesky_tri"):
        s = dict(BASE, linear_solver=name)
        jr = jax.vmap(lambda p: jax_qp_solve(p, JaxQPSettings(**s)))(
            JaxQP(*(jnp.asarray(a[k]) for k in LEAVES)))
        pr = qp_solve_batch(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"),
                            QPSettings(**s))
        for k in ("status", "iter"):
            np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                          np.asarray(getattr(jr.info, k)), err_msg=name)
        np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=ATOL, rtol=0,
                                   err_msg=name)
    with pytest.raises(ValueError, match="unknown linear_solver"):
        get_linear_solver("lu")


@pytest.mark.parametrize("branch", ["damped", "plain", "skip"])
def test_bfgs_update_matches_jax(branch):
    """The damping at s'y < 0.2 s'Bs, the plain update and the skip at
    s'r < eps (s = 0, NaN-safe), batch-first against the JAX update of each
    problem; the masks reset to I and pass B through."""
    rng = np.random.default_rng(5)
    G = rng.normal(size=(3, 4, 4))
    B = np.einsum("bij,bkj->bik", G, G) + np.eye(4)
    s = rng.normal(size=(3, 4))
    if branch == "damped":
        y = -np.einsum("bij,bj->bi", B, s)  # s'y < 0
    elif branch == "plain":
        y = np.einsum("bij,bj->bi", B, s) + 0.1 * s  # s'y > 0.2 s'Bs
    else:
        s = np.zeros_like(s)
        y = rng.normal(size=(3, 4))
    out = bfgs_update(torch.as_tensor(B), torch.as_tensor(s), torch.as_tensor(y)).numpy()
    for i in range(3):
        ref = np.asarray(jax_bfgs_update(jnp.asarray(B[i]), jnp.asarray(s[i]), jnp.asarray(y[i])))
        np.testing.assert_allclose(out[i], ref, atol=1e-12, rtol=1e-12)
        one = bfgs_update(torch.as_tensor(B[i]), torch.as_tensor(s[i]), torch.as_tensor(y[i]))
        np.testing.assert_allclose(one.numpy(), ref, atol=1e-12, rtol=1e-12)
    if branch == "skip":
        np.testing.assert_array_equal(out, B)
    else:
        assert np.abs(out - B).max() > 1e-3
    sy = np.einsum("bi,bi->b", s, y)
    sBs = np.einsum("bi,bij,bj->b", s, B, s)
    assert (sy < 0.2 * sBs).all() == (branch == "damped")
    masked = bfgs_update(torch.as_tensor(B), torch.as_tensor(s), torch.as_tensor(y),
                         reset=torch.tensor([True, False, False]),
                         upd=torch.tensor([True, False, True])).numpy()
    np.testing.assert_array_equal(masked[0], np.eye(4))
    np.testing.assert_array_equal(masked[1], B[1])
    np.testing.assert_array_equal(masked[2], out[2])


# the class shims, mirroring tests/test_qp.py::TestStatefulWrapper and
# tests/test_sqp.py::TestWrapperAPI


def test_qp_solver_multiple_solve_and_uninitialized():
    solver = QPSolver()
    with pytest.raises(RuntimeError, match="setup"):
        solver.solve()
    solver.setup(simple_qp(device="cpu"))
    solver.solve()
    assert solver._status == QPStatus.SOLVED
    solver.solve()
    assert solver._status == QPStatus.SOLVED
    np.testing.assert_allclose(solver.primal_solution().numpy(), SIMPLE_QP_SOLUTION, atol=1e-2)
    assert solver.dual_solution().shape == (3,)
    assert int(solver.info.status) == QPStatus.SOLVED
    # the early return of a solver never set up
    fresh = QPSolver()
    fresh._qp = simple_qp(device="cpu")
    assert fresh.solve() is None


def test_qp_solver_update_qp():
    qp = simple_qp(device="cpu")
    solver = QPSolver()
    solver.setup(qp)
    solver.solve()
    np.testing.assert_allclose(solver.primal_solution().numpy(), SIMPLE_QP_SOLUTION, atol=1e-2)
    # P -> I, q -> 0: the solution moves to [0.5, 0.5]
    qp2 = dataclasses.replace(qp, P=torch.eye(2, dtype=qp.P.dtype), q=torch.zeros(2, dtype=qp.P.dtype))
    solver.update_qp(qp2)
    solver.solve()
    np.testing.assert_allclose(solver.primal_solution().numpy(), [0.5, 0.5], atol=1e-2)
    with pytest.raises(ValueError, match="same problem dimensions"):
        solver.update_qp(QuadraticProblem(P=torch.eye(3, dtype=qp.P.dtype), q=torch.zeros(3),
                                          A=torch.zeros(3, 3), l=qp.l, u=qp.u))


def test_qp_solver_warm_start_is_real():
    """warm_start=True reuses the previous iterate; False starts from zero
    every time (the reference's reset is a no-op bug)."""
    qp = simple_qp(device="cpu")
    warm = QPSolver(QPSettings(warm_start=True))
    warm.setup(qp)
    r1 = warm.solve()
    r2 = warm.solve()
    assert int(r2.info.iter) < int(r1.info.iter)
    cold = QPSolver(QPSettings(warm_start=False))
    cold.setup(qp)
    c1, c2 = cold.solve(), cold.solve()
    assert int(c1.info.iter) == int(c2.info.iter) == int(r1.info.iter)
    np.testing.assert_array_equal(c1.x.numpy(), c2.x.numpy())
    np.testing.assert_array_equal(
        QPSolver.constr_type_init(np.array([42.0, -1e20]), np.array([42.0, 1e20])), [1, 2])


def test_sqp_shim_workflow_and_zero_init():
    solver = SQP()
    res = solver.solve(simple_nlp(device="cpu"), torch.tensor([1.2, 0.1], dtype=torch.float64))
    np.testing.assert_allclose(solver.primal_solution().numpy(), SIMPLE_NLP_SOLUTION, atol=1e-2)
    assert solver.dual_solution().shape == (3,)
    assert int(solver.info.iter) >= 1 and int(res.info.qp_solver_iter) > 0
    solver.solve(simple_qp_nlp(device="cpu"), num_var=2)
    np.testing.assert_allclose(solver.primal_solution().numpy(), SIMPLE_QP_SOLUTION, atol=1e-2)
    with pytest.raises(ValueError, match="num_var"):
        solver.solve(simple_qp_nlp(device="cpu"))
    seen = []
    SQP(SQPSettings(iteration_callback=lambda x, lam, k: seen.append((k, tuple(x.shape))))
        ).solve(simple_nlp(device="cpu"), torch.tensor([1.2, 0.1], dtype=torch.float64))
    assert seen[0] == (0, (2,)) and [k for k, _ in seen] == list(range(len(seen)))
