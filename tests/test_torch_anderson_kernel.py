"""In-kernel Anderson acceleration of the dense whole-solve tiers (plain
PyTorch versions) against the JAX package.

The same numpy inputs, float64, go through the JAX kernels (in interpret
mode on the CPU) and through the port's plain versions with
``acceleration="anderson"``: the whole-QP solve (K3,
``qp_solve_batch(impl="kernel")``) at memories 1, 4 and 8, with and without
adaptive rho and the infeasibility certificates, and the SQP step (K1),
including the SOC re-solve that reuses the factor.  Statuses, iteration
and rho-update counts are equal; x, y, z to atol 1e-9 (float64 summed in
another order through up to 400 ADMM iterations), the adaptive rho to
rtol 1e-6 (ROADMAP Queue 3).  Then the port against itself: the kernel
tier's Anderson against the fused tier's on the same problems, and
Anderson cutting the kernel tier's mean iterations below 0.6 of plain.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel import sqp_step_kernel as jax_step
from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models.mpc import random_qp_batch
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus
from sqp_solver_tpu_torch.testing import certificate_qp_inputs, qp_inputs, step_inputs

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
# the one-shot QP leg's schedule, run longer and tighter so that Anderson
# has pairs to extrapolate through
AA = dict(alpha=1.6, eps_abs=1e-7, eps_rel=1e-7, max_iter=400, check_termination=25,
          adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
          acceleration="anderson")


def _solve_both(a, settings, warm):
    jq = JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))
    jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy")) if warm else None
    jr = jax_qp_solve_batch(jq, JaxQPSettings(**settings), state=jst, impl="kernel")
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu") if warm else None
    pr = qp_solve_batch(pq, QPSettings(**settings), state=pst, impl="kernel")
    return jr, interop.qp_result_to_numpy(pr)


def _assert_qp_equal(jr, port):
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(port[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(jr, k)), atol=ATOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(port["rho_estimate"], np.asarray(jr.info.rho_estimate),
                               rtol=1e-6)


@pytest.mark.parametrize("memory,adaptive", [(1, False), (4, True), (8, True)])
def test_k3_anderson_matches_jax(memory, adaptive):
    """Warm-started random QPs with a loose and an equality row: Anderson
    at memory 1 (one pair), 4 and 8 (more pairs than chunks in an epoch,
    so the ring is emptied by the rho refactors before it fills)."""
    a = qp_inputs(6, 8, 9, seed=1, loose_row=True, equality_row=memory == 8)
    s = dict(AA, anderson_memory=memory, adaptive_rho=adaptive)
    jr, port = _solve_both(a, s, warm=True)
    _assert_qp_equal(jr, port)
    assert (port["status"] == QPStatus.SOLVED).all()
    if adaptive:
        assert (port["rho_updates"] > 1).any()


def test_k3_anderson_with_certificates_matches_jax():
    """Feasible, primal- and dual-infeasible problems in one batch: the
    certificates take the accepted deltas.  Infeasible iterates run off
    along the certificate (|x| up to ~6e4), and there the difference pairs
    are nearly parallel: the Gram's condition reaches the inverse of its
    Levenberg term, 1e8, so the two float64 codes agree to rtol 1e-7
    there (measured 6.7e-9), and to atol 1e-9 on the solved problems."""
    a = certificate_qp_inputs(6, 5, seed=3)
    s = dict(AA, anderson_memory=4, max_iter=200, eps_abs=1e-5, eps_rel=1e-5,
             check_infeasibility=True)
    jr, port = _solve_both(a, s, warm=False)
    solved = port["status"] == QPStatus.SOLVED
    assert solved.any()
    assert {QPStatus.PRIMAL_INFEASIBLE, QPStatus.DUAL_INFEASIBLE} <= set(port["status"])
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(port[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        want = np.asarray(getattr(jr, k))
        np.testing.assert_allclose(port[k][solved], want[solved], atol=ATOL, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(port[k][~solved], want[~solved], atol=ATOL, rtol=1e-7,
                                   err_msg=k)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_t(a):
    """batch-first numpy -> JAX kernel layout (batch last)"""
    return jnp.asarray(np.moveaxis(a, 0, -1))


def _np(a):
    return np.moveaxis(np.asarray(a), -1, 0)


STEP = dict(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=200, check_termination=10,
            adaptive_rho=True, adaptive_rho_interval=40, acceleration="anderson",
            anderson_memory=3)


def _run_jax_step(a, do_bfgs, minv_in=None, rho_in=None):
    batch = a["g"].shape[0]
    msk = np.zeros((8, batch))
    msk[0], msk[1], msk[2] = a["reset"], a["upd"], a["active"]
    msk[3] = np.zeros(batch) if rho_in is None else rho_in
    out = jax_step(
        *(_jax_t(a[k]) for k in ("B", "J", "g", "l", "u", "s", "dgl")), jnp.asarray(msk),
        *(_jax_t(a[k]) for k in ("x", "z", "y")), JaxQPSettings(**STEP), do_bfgs=do_bfgs,
        minv_in=None if minv_in is None else _jax_t(minv_in), want_minv=True,
        interpret=True)
    st = np.asarray(out[4])
    return dict(p=_np(out[0]), z=_np(out[1]), y=_np(out[2]), B=_np(out[3]),
                done=st[0] > 0.5, iter=st[1].astype(np.int32), fail=st[4] > 0.5,
                rho_updates=st[5].astype(np.int32), rho_estimate=st[6],
                rho_factor=st[7], minv=_np(out[5]))


def _run_port_step(a, do_bfgs, minv_in=None, rho_in=None):
    out = qk.sqp_step_kernel(
        *(_t(a[k]) for k in ("B", "J", "g", "l", "u", "s", "dgl", "reset", "upd", "active",
                             "x", "z", "y")),
        QPSettings(**STEP), do_bfgs=do_bfgs,
        rho_in=None if rho_in is None else _t(rho_in),
        minv_in=None if minv_in is None else _t(minv_in), want_minv=True)
    return {k: v.numpy() for k, v in out._asdict().items() if isinstance(v, torch.Tensor)}


def _assert_step_equal(port, ref, active):
    for k in ("done", "iter", "fail", "rho_updates"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in ("p", "z", "y", "B"):
        np.testing.assert_allclose(port[k], ref[k], atol=ATOL, rtol=0, err_msg=k)
    for k in ("rho_estimate", "rho_factor"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, err_msg=k)
    # the TPU factors a whole tile; the port leaves an inactive problem's Minv 0
    np.testing.assert_allclose(port["minv"][active], ref["minv"][active], atol=ATOL)


def test_k1_anderson_and_soc_reuse_match_jax():
    """The SQP step with Anderson (reset, damped, no-update, posdef-fallback
    and inactive problems in one batch), then the SOC re-solve: the first
    solve's Minv and rho with shifted bounds, a fresh ring, no setup
    factorization."""
    a = step_inputs(8, 6, 9, seed=11)
    port = _run_port_step(a, True)
    ref = _run_jax_step(a, True)
    _assert_step_equal(port, ref, a["active"])
    assert port["done"][:-1].any() and (port["rho_updates"] > 1).any()
    b = dict(a, B=ref["B"], l=a["l"] - 0.01, u=a["u"] - 0.01, x=ref["p"], z=ref["z"],
             y=ref["y"])
    kw = dict(minv_in=ref["minv"], rho_in=ref["rho_factor"])
    port = _run_port_step(b, False, **kw)
    ref = _run_jax_step(b, False, **kw)
    _assert_step_equal(port, ref, a["active"])


KERNEL_TIER = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=2000, check_termination=25,
                   schedule="fixed")


def _random_batch():
    return random_qp_batch(32, 8, 12, seed=1, dtype=torch.float64, device="cpu")


def test_kernel_tier_anderson_matches_fused_tier_anderson():
    """The same scheme on the two tiers (JAX tests/test_acceleration.py:
    125-143): the kernel tier packs the iterate as (x, z, y) and solves by
    Gauss-Jordan, the fused tier as (x, z, 0, y) with a library solve; in
    float64 the counts are equal and the solutions agree to 1e-6."""
    qp = _random_batch()
    s = QPSettings(**KERNEL_TIER, acceleration="anderson")
    ker = qp_solve_batch(qp, s, impl="kernel")
    fus = qp_solve_batch(qp, s, impl="fused")
    assert (ker.info.status == QPStatus.SOLVED).all()
    np.testing.assert_array_equal(ker.info.iter.numpy(), fus.info.iter.numpy())
    np.testing.assert_allclose(ker.x.numpy(), fus.x.numpy(), atol=1e-6, rtol=0)


def test_kernel_tier_anderson_cuts_iterations():
    """JAX tests/test_acceleration.py:145-160: under 0.6 of plain's mean."""
    qp = _random_batch()
    s = QPSettings(**KERNEL_TIER)
    plain = qp_solve_batch(qp, s, impl="kernel")
    aa = qp_solve_batch(qp, dataclasses.replace(s, acceleration="anderson"), impl="kernel")
    it_p = plain.info.iter.double().mean().item()
    it_a = aa.info.iter.double().mean().item()
    assert it_a < 0.6 * it_p, (it_p, it_a)
    assert (aa.info.status == QPStatus.SOLVED).all()
