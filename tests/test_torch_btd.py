"""The port's structured tier (plain PyTorch versions) against the JAX package.

The same numpy inputs, float64, go through the JAX package (its Pallas
kernels in interpret mode on the CPU) and through the port: the
block-tridiagonal whole-QP solve (K6, ``qp_solve_kernel_btd`` and its
route from ``qp_solve_kernel``), the structured SQP step (K7,
``btd_step_kernel``), the per-stage band BFGS, the structured SQP tier
``sqp_solve_batch(qp_impl="kernel_btd")`` and the stage-wise families.

Tolerances.  Statuses, iteration and rho-update counts are equal.  On the
random band QPs (no equality rows, T = 4) x, y and z agree to atol 1e-9
(measured worst 7.1e-15), and so they do on the stage-wise MPC QP, whose
2 T dynamics rows are equalities (measured worst 8.6e-14, cold and warm,
native and padded blocking); the SQP tier's x and lambda to atol 1e-8.
The adaptive rho, a ratio of residual norms near the float64 floor,
agrees to rtol 1e-6 (ROADMAP Queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.mpc import mpc_nlp_kkt_residuals as jax_kkt_residuals
from sqp_solver_tpu.models.mpc import mpc_nlp_stagewise_batch as jax_nlp_family
from sqp_solver_tpu.models.mpc import mpc_qp_stagewise_batch as jax_qp_family
from sqp_solver_tpu.ops.qp_kernel_btd import btd_step_kernel as jax_btd_step
from sqp_solver_tpu.ops.qp_kernel_btd import qp_solve_kernel_btd as jax_qp_btd
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu.sqp.solver_btd import _bfgs_update_band as jax_bfgs_band
from sqp_solver_tpu.sqp.solver_btd import sqp_solve_kernel_btd as jax_sqp_btd
from sqp_solver_tpu.sqp.types import SQPSettings as JaxSQPSettings
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models.mpc import (
    mpc_nlp_kkt_residuals,
    mpc_nlp_stagewise_batch,
    mpc_qp_stagewise_batch,
)
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPState, QPStatus
from sqp_solver_tpu_torch.sqp.solver_btd import bfgs_update_band
from sqp_solver_tpu_torch.sqp.types import SQPSettings
from sqp_solver_tpu_torch.testing import btd_qp_inputs, btd_step_inputs

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
# the one-shot QP leg's schedule: 200 iterations in 4 rho epochs of 2
# chunks of 25, with the structured linear solver
BTD = dict(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
           adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
           linear_solver="schur_block_tridiag")
INFO = ("status", "iter", "rho_updates")


def _jax_qp(a):
    return JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))


def _port_qp(a):
    return interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")


def _assert_qp_equal(pr, jr, atol):
    p = interop.qp_result_to_numpy(pr)
    for k in INFO:
        np.testing.assert_array_equal(p[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(p["rho_estimate"], np.asarray(jr.info.rho_estimate), rtol=1e-6)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k], np.asarray(getattr(jr, k)), atol=atol, rtol=0,
                                   err_msg=k)


def _mpc_arrays(batch, horizon, seed=0):
    jq, b = jax_qp_family(batch, horizon=horizon, seed=seed, dtype=jnp.float64)
    return {k: np.array(getattr(jq, k)) for k in LEAVES}, b


@pytest.mark.parametrize("warm", [False, True])
def test_k6_random_band_qps_match_jax(warm):
    """Random block-tridiagonal QPs at T = 4 blocks (n = 32, bb = 8,
    m = 24, a loose row), so each sweep chain runs three coupled steps,
    cold and warm-started: K6's plain version against the JAX kernel."""
    a = btd_qp_inputs(5, 4, 8, 24, seed=3, loose_row=True)
    s = dict(BTD, block_size=8)
    jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy")) if warm else None
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s), state=jst)
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu") if warm else None
    pr = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s), state=pst)
    _assert_qp_equal(pr, jr, ATOL)
    assert (pr.info.status.numpy() == QPStatus.SOLVED).all()


def test_btd_apply_solves_the_band_system():
    """The four-phase apply of the block-Thomas factor (c = L^-1 b, the
    forward chain, d = L^-T w, the backward chain) against
    ``torch.linalg.solve`` of the assembled band M at T = 5, float64."""
    t = btd_step_inputs(3, 5, 8, 30, seed=6)
    pd, pe, A = (torch.as_tensor(t[k]) for k in ("pd", "pe", "J"))
    rv = torch.as_tensor(np.random.default_rng(6).uniform(0.1, 2.0, size=(3, 30)))
    factor, fail = qb._btd_factor(pd, pe, A, rv, 1e-6)
    assert not fail.any()
    n = 40
    M = 1e-6 * torch.eye(n, dtype=torch.float64) + A.mT @ (A * rv[..., None])
    for k in range(5):
        o = slice(8 * k, 8 * k + 8)
        M[:, o, o] += pd[:, k]
        if k < 4:
            p = slice(8 * k + 8, 8 * k + 16)
            M[:, p, o] += pe[:, k]
            M[:, o, p] += pe[:, k].mT
    b = torch.as_tensor(np.random.default_rng(7).normal(size=(3, n)))
    want = torch.linalg.solve(M, b)
    np.testing.assert_allclose(qb._btd_apply(factor, b).numpy(), want.numpy(), atol=1e-10,
                               rtol=0)


def test_k6_mpc_family_and_route_match_jax():
    """The stage-wise MPC QP at horizon 4 (n = 12, declared block 3, so
    bb = 8 and n is padded to 16): through ``qp_solve_batch(impl="kernel")``,
    which routes to K6, against the JAX kernel; the route gives exactly
    what the structured entry gives."""
    a, b = _mpc_arrays(4, 4)
    s = dict(BTD, block_size=b)
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s))
    pr = qp_solve_batch(_port_qp(a), QPSettings(**s), impl="kernel")
    _assert_qp_equal(pr, jr, ATOL)
    assert (pr.info.status.numpy() == QPStatus.SOLVED).all()
    direct = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s))
    via = qk.qp_solve_kernel(_port_qp(a), QPSettings(**s))
    for r in (direct, via):
        assert torch.equal(r.x, pr.x) and torch.equal(r.info.status, pr.info.status)


def test_k6_n_padding_and_warm_start_match_jax():
    """Declared block 5 (bb = 16) on the MPC family at horizon 4 pads n = 12
    to 16 with decoupled identity rows; then a warm start from that result.
    Both against the JAX kernel, and the padded solve agrees with the
    native blocking."""
    a, b = _mpc_arrays(4, 4, seed=1)
    s = dict(BTD, block_size=5)
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s))
    pr = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s))
    assert pr.x.shape == (4, 12)
    _assert_qp_equal(pr, jr, ATOL)
    jw = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s), state=jr.state)
    pw = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s), state=pr.state)
    _assert_qp_equal(pw, jw, ATOL)
    assert pw.info.iter.max() <= pr.info.iter.max()
    native = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**dict(BTD, block_size=b)))
    np.testing.assert_allclose(pr.x.numpy(), native.x.numpy(), atol=1e-4)


def _certificate_band_inputs():
    """Band QPs (n = 16, bb = 8, m = 12): problem 0 feasible, problem 1
    primal infeasible (rows 0 and 1 the same vector with a'x <= -1 and
    a'x >= 1), problem 2 dual infeasible (P and every row but row 11 blind
    to x_0, q_0 = -1, row 11 = e_0 with e_0'x >= 0), problem 3 with an
    indefinite diagonal block (P_00 = -10 I)."""
    a = btd_qp_inputs(4, 2, 8, 12, seed=7)
    a["x"][:] = 0.0
    a["z"][:] = 0.0
    a["y"][:] = 0.0
    a["A"][1, 1] = a["A"][1, 0]
    a["l"][1, 0], a["u"][1, 0] = -1e30, -1.0
    a["l"][1, 1], a["u"][1, 1] = 1.0, 1e30
    a["P"][2, 0, :] = a["P"][2, :, 0] = 0.0
    a["q"][2, 0] = -1.0
    a["A"][2, :, 0] = 0.0
    a["A"][2, 11] = 0.0
    a["A"][2, 11, 0] = 1.0
    a["l"][2, 11], a["u"][2, 11] = 0.0, 1e30
    a["P"][3, :8, :8] = -10.0 * np.eye(8)
    return a


def test_k6_certificates_and_numerical_issues_match_jax():
    a = _certificate_band_inputs()
    s = dict(BTD, block_size=8)
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s))
    pr = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s))
    status = pr.info.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(jr.info.status))
    assert list(status) == [QPStatus.SOLVED, QPStatus.PRIMAL_INFEASIBLE,
                            QPStatus.DUAL_INFEASIBLE, QPStatus.NUMERICAL_ISSUES]
    # infeasible iterates run off along the certificate: relative agreement
    p = interop.qp_result_to_numpy(pr)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k][:3], np.asarray(getattr(jr, k))[:3], atol=ATOL,
                                   rtol=1e-9, err_msg=k)


def _jax_step(t, settings):
    msk = np.zeros((8, t["g"].shape[0]))
    msk[2] = t["active"]
    msk[3] = t["rho_in"]
    args = [interop.band_to_kernel_layout(torch.as_tensor(t[k])) for k in ("pd", "pe")]
    args += [np.moveaxis(t[k], 0, -1) for k in ("J", "g", "l", "u")]
    args += [msk] + [np.moveaxis(t[k], 0, -1) for k in ("x", "z", "y")]
    p, z, y, st = jax_btd_step(*(jnp.asarray(v) for v in args), JaxQPSettings(**settings))
    return np.asarray(p).T, np.asarray(z).T, np.asarray(y).T, np.asarray(st)


def test_k7_step_matches_jax():
    """K7 on band inputs with a carried rho on every second problem and the
    last problem inactive: iterates and the nine stats rows, row 8 the rho
    of the final factor."""
    t = btd_step_inputs(5, 2, 8, 12, seed=4)
    s = dict(BTD, block_size=8, max_iter=100)
    jp, jz, jy, st = _jax_step(t, s)
    tt = {k: torch.as_tensor(v) for k, v in t.items()}
    out = qb.btd_step_kernel(tt["pd"], tt["pe"], tt["J"], tt["g"], tt["l"], tt["u"],
                             tt["active"], tt["x"], tt["z"], tt["y"], QPSettings(**s),
                             rho_in=tt["rho_in"])
    for name, a, b in (("p", out.x, jp), ("z", out.z, jz), ("y", out.y, jy)):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0, err_msg=name)
    rows = (out.done, out.iter, out.res_prim, out.res_dual, out.fail, out.rho_updates,
            out.rho_estimate, out.infs, out.rho_factor)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r.double().numpy(), st[i], rtol=1e-6, atol=1e-12,
                                   err_msg=f"stats row {i}")
    # the inactive problem passes its warm start through
    np.testing.assert_array_equal(out.x[-1].numpy(), t["x"][-1])
    assert int(out.iter[-1]) == 0 and bool(out.done[-1])
    # a carried rho differs from rho0 in the first factor
    assert not torch.equal(out.rho_factor[1::2], torch.full_like(out.rho_factor[1::2], 0.1))


def test_k7_long_chain_matches_jax():
    """K7 at T = 4 blocks (n = 32, bb = 8, m = 24), a carried rho on every
    second problem and the last problem inactive: iterates and the nine
    stats rows against the JAX kernel."""
    t = btd_step_inputs(3, 4, 8, 24, seed=12)
    s = dict(BTD, block_size=8, max_iter=100)
    jp, jz, jy, st = _jax_step(t, s)
    tt = {k: torch.as_tensor(v) for k, v in t.items()}
    out = qb.btd_step_kernel(tt["pd"], tt["pe"], tt["J"], tt["g"], tt["l"], tt["u"],
                             tt["active"], tt["x"], tt["z"], tt["y"], QPSettings(**s),
                             rho_in=tt["rho_in"])
    for name, a, b in (("p", out.x, jp), ("z", out.z, jz), ("y", out.y, jy)):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0, err_msg=name)
    rows = (out.done, out.iter, out.res_prim, out.res_dual, out.fail, out.rho_updates,
            out.rho_estimate, out.infs, out.rho_factor)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r.double().numpy(), st[i], rtol=1e-6, atol=1e-12,
                                   err_msg=f"stats row {i}")
    assert int(out.iter[0]) > 0 and int(out.iter[-1]) == 0


def test_band_bfgs_matches_jax():
    rng = np.random.default_rng(5)
    B, T, bb = 6, 3, 8
    n = T * bb
    G = rng.normal(size=(B, T, bb, bb))
    band = G @ G.transpose(0, 1, 3, 2) / bb + np.eye(bb)
    s = rng.normal(size=(B, n))
    yv = np.einsum("btij,btj->bti", band, s.reshape(B, T, bb)).reshape(B, n)
    yv += 0.1 * rng.normal(size=(B, n))
    yv[1] *= -1.0  # negative curvature: the damped branch
    s[2, :bb] = 0.0  # one block without curvature keeps its estimate
    reset = np.array([True, False, False, False, False, False])
    upd = np.array([True, True, True, False, True, True])
    ref = jax_bfgs_band(jnp.asarray(interop.band_to_kernel_layout(torch.as_tensor(band))),
                        jnp.asarray(s), jnp.asarray(yv), jnp.asarray(reset),
                        jnp.asarray(upd), bb)
    out = bfgs_update_band(torch.as_tensor(band), torch.as_tensor(s), torch.as_tensor(yv),
                           torch.as_tensor(reset), torch.as_tensor(upd))
    np.testing.assert_allclose(
        out.numpy(), interop.band_from_kernel_layout(ref, device="cpu").numpy(),
        atol=1e-12, rtol=0)
    assert np.array_equal(out[0].numpy(), np.broadcast_to(np.eye(bb), (T, bb, bb)))
    assert np.array_equal(out[3].numpy(), band[3])
    assert np.array_equal(out[2, 0].numpy(), band[2, 0])


NLP = dict(max_iter=10, eps_prim=1e-5, eps_dual=1e-5, termination="kkt",
           qp_impl="kernel_btd")
NLP_QP = dict(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=300, check_termination=25,
              warm_start=True, adaptive_rho=True, adaptive_rho_interval=50,
              check_infeasibility=False)


@pytest.mark.parametrize("variant", ["plain", "soc", "polish"])
def test_structured_sqp_tier_matches_jax(variant):
    """sqp_solve_batch(qp_impl="kernel_btd") against JAX
    ``sqp_solve_kernel_btd`` on the unicycle family at horizon 4 (n = 16,
    m = 28, block 4), 10 outer iterations."""
    jp, jx0, b = jax_nlp_family(4, horizon=4, seed=2, dtype=jnp.float64)
    extra = dict(second_order_correction=variant == "soc", polish=variant == "polish",
                 polish_passes=1)
    jset = JaxSQPSettings(qp=JaxQPSettings(**NLP_QP, block_size=b), **NLP, **extra)
    jr = jax_sqp_btd(jp, jx0, None, jset)
    pp = interop.mpc_nlp_from_arrays(jp.l, jp.u, jp.params, 4, device="cpu")
    pset = SQPSettings(qp=QPSettings(**NLP_QP, block_size=b), **NLP, **extra)
    pr = sqp_solve_batch(pp, torch.as_tensor(np.array(jx0)), None, pset, impl="fused")
    for k in ("status", "iter", "qp_solver_iter"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=1e-8, rtol=0)
    if variant == "polish":
        # honest statuses: every SOLVED problem certifies in float64
        pv, dr = mpc_nlp_kkt_residuals(pp, pr.x, pr.lam, 4)
        solved = pr.info.status.numpy() == 0
        assert solved.any() and (pv[solved] < 1e-5).all() and (dr[solved] < 1e-5).all()


def test_families_give_identical_data():
    """One seed gives the same stage-wise QP and unicycle NLP in both
    packages; the NLP's objective, constraints and float64 certificate
    agree at a random point."""
    jq, jb = jax_qp_family(3, horizon=5, seed=4, dtype=jnp.float64)
    pq, pb = mpc_qp_stagewise_batch(3, horizon=5, seed=4, dtype=torch.float64, device="cpu")
    assert jb == pb == 3
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(pq, k).numpy(), np.asarray(getattr(jq, k)))
    jp, jx0, jb = jax_nlp_family(3, horizon=5, seed=4, dtype=jnp.float64)
    pp, px0, pb = mpc_nlp_stagewise_batch(3, horizon=5, seed=4, dtype=torch.float64,
                                          device="cpu")
    assert jb == pb == 4
    np.testing.assert_array_equal(px0.numpy(), np.asarray(jx0))
    for k in ("l", "u", "params"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(), np.asarray(getattr(jp, k)))
    rng = np.random.default_rng(0)
    x = np.asarray(jx0) + 0.1 * rng.normal(size=jx0.shape)
    lam = rng.normal(size=(3, 35))
    import jax

    jf = jax.vmap(jp.objective)(jnp.asarray(x), jp.params)
    jc = jax.vmap(jp.constraint)(jnp.asarray(x), jp.params)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(pp.objective(xt, pp.params).numpy(), np.asarray(jf),
                               rtol=1e-14)
    np.testing.assert_allclose(pp.constraint(xt, pp.params).numpy(), np.asarray(jc),
                               atol=1e-14)
    for a, b in zip(mpc_nlp_kkt_residuals(pp, xt, torch.as_tensor(lam), 5),
                    jax_kkt_residuals(jp, x, lam, 5)):
        np.testing.assert_allclose(a, b, atol=1e-14)
    rebuilt = interop.mpc_nlp_from_arrays(jp.l, jp.u, jp.params, 5, device="cpu")
    assert torch.equal(rebuilt.constraint(xt, rebuilt.params), pp.constraint(xt, pp.params))


def test_band_layout_round_trip():
    band = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 4, 8, 8)))
    k = interop.band_to_kernel_layout(band)
    assert k.shape == (32, 8, 3)
    np.testing.assert_array_equal(k[8:16, :, 2], band[2, 1].numpy())
    assert torch.equal(interop.band_from_kernel_layout(k, device="cpu"), band)
    P = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 24, 24)))
    pd, pe = qb.extract_band(P, 8)
    assert torch.equal(pd[1, 2], P[1, 16:24, 16:24])
    assert torch.equal(pe[0, 1], P[0, 16:24, 8:16])
    assert not pe[:, 2].any()


def test_structured_wrappers_launch_nothing_on_cpu():
    a = btd_qp_inputs(2, 2, 8, 10, seed=9)
    before = (qb.qp_solve_btd_launches, qb.btd_step_launches)
    qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**dict(BTD, block_size=8, max_iter=25)))
    t = {k: torch.as_tensor(v) for k, v in btd_step_inputs(3, 2, 8, 10, seed=9).items()}
    qb.btd_step_kernel(t["pd"], t["pe"], t["J"], t["g"], t["l"], t["u"], t["active"],
                       t["x"], t["z"], t["y"], QPSettings(**dict(BTD, block_size=8,
                                                                 max_iter=25)))
    assert (qb.qp_solve_btd_launches, qb.btd_step_launches) == before
    # n = 24 is no multiple of the internal block 16 of a declared block 5
    t = {k: torch.as_tensor(v) for k, v in btd_step_inputs(3, 3, 8, 10, seed=9).items()}
    with pytest.raises(ValueError, match="multiple"):
        qb.btd_step_kernel(t["pd"], t["pe"], t["J"], t["g"], t["l"], t["u"], t["active"],
                           t["x"], t["z"], t["y"], QPSettings(**dict(BTD, block_size=5)))
    zero = QPState.zeros(2, 16, 10, dtype=torch.float64, device="cpu")
    r = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**dict(BTD, block_size=8)), zero)
    assert r.x.shape == (2, 16)
