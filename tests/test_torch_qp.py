"""The port's QP serving kernels (plain PyTorch versions) against the JAX package.

The same numpy inputs, float64, go through the JAX package (its Pallas
kernels in interpret mode on the CPU) and through the port's plain
versions: the whole-QP solve ``qp_solve_batch(impl="kernel")`` (K3),
the SPD inverse (K4), ``kkt_solve_schur_refined`` on both routes and
``polish_qp``.  Statuses, iteration and rho-update counts must be equal;
iterates agree to atol 1e-9 (float64 summed in another order through up
to 200 ADMM iterations), and on infeasible problems, whose iterates run
off along the certificate (|y| up to ~1e4), to atol 1e-9 plus rtol 1e-9;
the adaptive rho, a ratio of residual norms near the float64 floor, to
rtol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel import spd_inverse_kernel as jax_spd_inverse
from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.polish import kkt_solve_schur_refined as jax_kkt
from sqp_solver_tpu.qp.polish import polish_qp as jax_polish_qp
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp import kkt_solve_schur_refined, polish_qp
from sqp_solver_tpu_torch.qp.types import QPSettings, QPState, QPStatus
from sqp_solver_tpu_torch.testing import (
    certificate_qp_inputs,
    polish_inputs,
    qp_inputs,
    spd_inputs,
)

ATOL = 1e-9
# the one-shot QP leg's settings (bench.py:814-818): 200 iterations in 4
# rho epochs of 2 chunks of 25
BENCH = dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200, check_termination=25,
             adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed")
LEAVES = ("P", "q", "A", "l", "u")


def _t(a):
    return torch.as_tensor(np.array(a))


def _solve_both(a, settings, warm):
    jq = JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))
    jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy")) if warm else None
    jr = jax_qp_solve_batch(jq, JaxQPSettings(**settings), state=jst, impl="kernel")
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu") if warm else None
    pr = qp_solve_batch(pq, QPSettings(**settings), state=pst, impl="kernel")
    return jr, interop.qp_result_to_numpy(pr)


def _assert_qp_equal(jr, port, scale_tol=False):
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(port[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(jr, k)), atol=ATOL,
                                   rtol=ATOL if scale_tol else 0, err_msg=k)
    for k in ("res_prim", "res_dual"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(jr.info, k)), atol=ATOL,
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(port["rho_estimate"], np.asarray(jr.info.rho_estimate),
                               rtol=1e-6)


def _case(name):
    """(inputs, settings, warm) of one parity case, B <= 8, n <= 10."""
    if name == "cold":
        return qp_inputs(6, 8, 9, seed=1), BENCH, False
    if name == "warm":
        return qp_inputs(6, 8, 9, seed=2), BENCH, True
    if name == "loose_and_equality_rows":
        return qp_inputs(6, 5, 7, seed=3, equality_row=True, loose_row=True), BENCH, True
    if name == "max_iter_not_a_multiple":
        # 60 = 2 chunks of 25 + 10: the second epoch runs a whole chunk and
        # info.iter is capped at max_iter
        return qp_inputs(6, 10, 11, seed=4), dict(BENCH, max_iter=60, eps_abs=1e-9,
                                                  eps_rel=1e-9), False
    if name == "polish":
        return (qp_inputs(6, 8, 9, seed=5, loose_row=True),
                dict(BENCH, polish=True, polish_passes=2), False)
    if name == "one_epoch":
        return qp_inputs(8, 6, 7, seed=6), dict(BENCH, adaptive_rho=False), True
    if name == "mpc":
        # the sustained-MPC family (shared P, A; loose-free box and velocity rows)
        from sqp_solver_tpu_torch.models.mpc import mpc_qp_batch

        qp = mpc_qp_batch(6, horizon=8, seed=6, dtype=torch.float64, device="cpu")
        a = {k: getattr(qp, k).numpy() for k in LEAVES}
        return a, BENCH, False
    raise KeyError(name)


@pytest.mark.parametrize("name", ["cold", "warm", "loose_and_equality_rows",
                                  "max_iter_not_a_multiple", "polish", "one_epoch", "mpc"])
def test_qp_solve_kernel_matches_jax(name):
    a, settings, warm = _case(name)
    jr, port = _solve_both(a, settings, warm)
    _assert_qp_equal(jr, port)
    if name == "max_iter_not_a_multiple":
        hit = port["status"] == QPStatus.MAX_ITER_EXCEEDED
        assert hit.any() and (port["iter"][hit] == 60).all()
        assert (port["iter"] <= 60).all()
    elif name not in ("polish", "one_epoch"):
        assert (port["status"] == QPStatus.SOLVED).all()


def test_qp_certificates_match_jax():
    """Feasible, primal-infeasible and dual-infeasible problems in one
    batch: the certified ones stop early and keep their status."""
    a = certificate_qp_inputs(6, 6, seed=7)
    jr, port = _solve_both(a, BENCH, False)
    _assert_qp_equal(jr, port, scale_tol=True)
    want = [QPStatus.SOLVED, QPStatus.PRIMAL_INFEASIBLE, QPStatus.DUAL_INFEASIBLE] * 2
    np.testing.assert_array_equal(port["status"], want)
    assert (port["iter"] < 200).all()


def test_nan_in_q_reaches_the_fail_flag():
    """rho = rho0 + 0 q_0: a NaN in q's first entry poisons rho and the
    first factorization fails; a NaN elsewhere in q gives NaN residuals,
    whose adaptive rho poisons rho at the next epoch and fails the
    refactor.  Both report NUMERICAL_ISSUES; their batch-mates are
    untouched."""
    a = qp_inputs(4, 5, 6, seed=8)
    a["q"][0, 0] = np.nan
    a["q"][1, 3] = np.nan
    jr, port = _solve_both(a, BENCH, False)
    np.testing.assert_array_equal(port["status"], np.asarray(jr.info.status))
    np.testing.assert_array_equal(port["status"], [QPStatus.NUMERICAL_ISSUES,
                                                   QPStatus.NUMERICAL_ISSUES,
                                                   QPStatus.SOLVED, QPStatus.SOLVED])
    np.testing.assert_array_equal(port["iter"], np.asarray(jr.info.iter))
    np.testing.assert_allclose(port["x"][2:], np.asarray(jr.x)[2:], atol=ATOL, rtol=0)


def test_spd_inverse_matches_jax():
    """Minv to 1e-9 and the fail flag equal, with a non-SPD problem 0."""
    a = spd_inputs(6, 9, seed=9)
    Minv, fail = qk.spd_inverse_kernel(_t(a["M"]))
    jm, jf = jax_spd_inverse(jnp.asarray(np.moveaxis(a["M"], 0, -1)))
    jf = np.asarray(jf) > 0.5
    np.testing.assert_array_equal(fail.numpy(), jf)
    assert jf[0] and not jf[1:].any()
    np.testing.assert_allclose(Minv.numpy()[1:], np.moveaxis(np.asarray(jm), -1, 0)[1:],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(Minv.numpy()[1:] @ a["M"][1:], np.broadcast_to(np.eye(9), (5, 9, 9)),
                               atol=1e-10)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_kkt_solve_schur_refined_matches_jax(use_kernel, warm):
    """Both routes (K2; K4 + Newton-Schulz + sweeps) against the JAX
    routes of the same name, with the active rows masked out of A."""
    a = polish_inputs(5, 8, 10, seed=10)
    H = a["H"].copy()
    H[0] = np.eye(8)  # polish_inputs' problem 0 is indefinite
    act = a["act"]
    A_m = np.where(act[..., None], a["J"], 0.0)
    x0 = a["x0"] if warm else None
    nu0 = a["nu0"] if warm else None
    kw = dict(delta=1e-2, sweeps=6, use_kernel=use_kernel)
    px, pnu, pfail = kkt_solve_schur_refined(
        _t(H), _t(A_m), _t(act), _t(a["r1"]), _t(a["b"]),
        x0=None if x0 is None else _t(x0), nu0=None if nu0 is None else _t(nu0), **kw)
    jx, jnu, jfail = jax_kkt(
        jnp.asarray(H), jnp.asarray(A_m), jnp.asarray(act), jnp.asarray(a["r1"]),
        jnp.asarray(a["b"]), x0=None if x0 is None else jnp.asarray(x0),
        nu0=None if nu0 is None else jnp.asarray(nu0), **kw)
    np.testing.assert_array_equal(pfail.numpy(), np.asarray(jfail))
    assert not pfail.any()
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pnu.numpy(), np.asarray(jnu), atol=ATOL, rtol=0)
    # one problem without the batch axis takes the same route
    x1, nu1, _ = kkt_solve_schur_refined(
        _t(H[1]), _t(A_m[1]), _t(act[1]), _t(a["r1"][1]), _t(a["b"][1]),
        x0=None if x0 is None else _t(x0[1]), nu0=None if nu0 is None else _t(nu0[1]),
        **kw)
    np.testing.assert_allclose(x1.numpy(), px.numpy()[1], atol=1e-12, rtol=0)


@pytest.mark.parametrize("passes", [1, 3])
def test_polish_qp_matches_jax(passes):
    """polish_qp on a loose ADMM iterate (K3, 50 iterations): the same
    accepted candidates, solution and duals.  The JAX package on the CPU
    takes its Cholesky route, the port its K2 route: the sweeps converge
    both to the same KKT point."""
    a = qp_inputs(6, 8, 9, seed=11, equality_row=True, loose_row=True)
    loose = dict(BENCH, max_iter=50, adaptive_rho=False)
    jq = JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))
    jr = jax_qp_solve_batch(jq, JaxQPSettings(**loose), impl="kernel")
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    pr = qp_solve_batch(pq, QPSettings(**loose), impl="kernel")
    jp = jax_polish_qp(jq, jr, JaxQPSettings(**loose), passes=passes)
    pp = polish_qp(pq, pr, QPSettings(**loose), passes=passes)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(pp, k).numpy(), np.asarray(getattr(jp, k)),
                                   atol=ATOL, rtol=0, err_msg=k)
    # polish moved the iterate (the test is not vacuous)
    assert np.abs(pp.x.numpy() - pr.x.numpy()).max() > 1e-6
    # one problem without the batch axis
    one = polish_qp(type(pq)(*(getattr(pq, k)[2] for k in LEAVES)),
                    type(pr)(x=pr.x[2], y=pr.y[2], z=pr.z[2], info=pr.info),
                    QPSettings(**loose), passes=passes)
    np.testing.assert_allclose(one.x.numpy(), pp.x.numpy()[2], atol=1e-12, rtol=0)


@pytest.mark.parametrize("kind", ["comp_slack"])
def test_qp_path_refuses_what_it_does_not_cover(kind):
    a = qp_inputs(2, 3, 4, seed=13)
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    settings = dataclasses.replace(QPSettings(**BENCH), check_comp_slack=True)
    with pytest.raises(ValueError, match="check_comp_slack"):
        qp_solve_batch(pq, settings, impl="kernel")


def test_qp_result_state_warm_starts_and_launches_nothing_on_cpu():
    a = qp_inputs(4, 6, 7, seed=14)
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    before = (qk.qp_solve_launches, qk.spd_inverse_launches, qk.polish_kkt_launches)
    cold = qp_solve_batch(pq, QPSettings(**BENCH), impl="kernel")
    assert isinstance(cold.state, QPState)
    warm = qp_solve_batch(pq, QPSettings(**BENCH), state=cold.state, impl="kernel")
    assert (warm.info.iter <= cold.info.iter).all() and (warm.info.iter < cold.info.iter).any()
    qk.spd_inverse_kernel(_t(spd_inputs(2, 3)["M"]))
    assert (qk.qp_solve_launches, qk.spd_inverse_launches, qk.polish_kkt_launches) == before
