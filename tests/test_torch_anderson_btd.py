"""In-kernel Anderson acceleration of the structured tier (plain PyTorch
versions of K6 and K7) against the JAX structured kernels in interpret
mode, float64, at horizons 4 to 8.

K6 and K7 run the dense kernels' ADMM core through its structured hooks,
so Anderson reaches them through the one core (``_admm_core``).  Statuses,
iteration and rho-update counts are equal; x, y, z to atol 1e-9; the
adaptive rho to rtol 1e-6 (ROADMAP Queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.mpc import mpc_qp_stagewise_batch as jax_qp_family
from sqp_solver_tpu.ops.qp_kernel_btd import btd_step_kernel as jax_btd_step
from sqp_solver_tpu.ops.qp_kernel_btd import qp_solve_kernel_btd as jax_qp_btd
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus
from sqp_solver_tpu_torch.testing import btd_qp_inputs, btd_step_inputs

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
# the one-shot QP leg's schedule with the structured solver, run tighter
# so that Anderson has pairs to extrapolate through
BTD_AA = dict(alpha=1.6, eps_abs=1e-7, eps_rel=1e-7, max_iter=300, check_termination=25,
              adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
              linear_solver="schur_block_tridiag", acceleration="anderson", anderson_memory=4)


def _jax_qp(a):
    return JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))


def _port_qp(a):
    return interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")


def _assert_qp_equal(pr, jr):
    p = interop.qp_result_to_numpy(pr)
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(p[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(p["rho_estimate"], np.asarray(jr.info.rho_estimate), rtol=1e-6)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k], np.asarray(getattr(jr, k)), atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("warm", [False, True])
def test_k6_anderson_random_band_matches_jax(warm):
    """Random band QPs at T = 4 blocks of 8 (a loose row), cold and warm."""
    a = btd_qp_inputs(5, 4, 8, 24, seed=3, loose_row=True)
    s = dict(BTD_AA, block_size=8)
    jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy")) if warm else None
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s), state=jst)
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu") if warm else None
    pr = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s), state=pst)
    _assert_qp_equal(pr, jr)
    assert (pr.info.status.numpy() == QPStatus.SOLVED).all()


@pytest.mark.parametrize("horizon,memory", [(4, 2), (8, 4)])
def test_k6_anderson_mpc_family_matches_jax(horizon, memory):
    """The stage-wise MPC QP (declared block 3, so bb = 8 and n padded)
    through ``qp_solve_batch(impl="kernel")``, which routes to K6, at
    horizons 4 and 8; Anderson cuts the mean iterations below plain's."""
    jq, b = jax_qp_family(4, horizon=horizon, seed=2, dtype=jnp.float64)
    a = {k: np.array(getattr(jq, k)) for k in LEAVES}
    s = dict(BTD_AA, block_size=b, anderson_memory=memory)
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s))
    pr = qp_solve_batch(_port_qp(a), QPSettings(**s), impl="kernel")
    _assert_qp_equal(pr, jr)
    plain = qp_solve_batch(_port_qp(a), QPSettings(**dict(s, acceleration="none")),
                           impl="kernel")
    assert pr.info.iter.double().mean() <= plain.info.iter.double().mean()


def _jax_step(t, settings):
    msk = np.zeros((8, t["g"].shape[0]))
    msk[2] = t["active"]
    msk[3] = t["rho_in"]
    args = [interop.band_to_kernel_layout(torch.as_tensor(t[k])) for k in ("pd", "pe")]
    args += [np.moveaxis(t[k], 0, -1) for k in ("J", "g", "l", "u")]
    args += [msk] + [np.moveaxis(t[k], 0, -1) for k in ("x", "z", "y")]
    p, z, y, st = jax_btd_step(*(jnp.asarray(v) for v in args), JaxQPSettings(**settings))
    return np.asarray(p).T, np.asarray(z).T, np.asarray(y).T, np.asarray(st)


@pytest.mark.parametrize("T", [2, 4])
def test_k7_anderson_step_matches_jax(T):
    """K7 with Anderson at T = 2 and 4 blocks of 8, a carried rho on every
    second problem and the last problem inactive: iterates and the nine
    stats rows against the JAX kernel."""
    t = btd_step_inputs(4, T, 8, 12 * T // 2, seed=4 + T)
    s = dict(BTD_AA, block_size=8, max_iter=150, anderson_memory=3)
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
    np.testing.assert_array_equal(out.x[-1].numpy(), t["x"][-1])
    assert int(out.iter[0]) > 0 and int(out.iter[-1]) == 0
