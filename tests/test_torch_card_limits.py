"""The shapes the card took last: internal blocks past 128 and Anderson
memories past 32, the port's plain versions against the JAX package.

On the card the wide structured kernel (``csrc/qp_kernel_btd_wide.cu``)
takes every internal block that is a multiple of 8 (its sweep chains run
their rows in rounds past 128), and every Anderson kernel any memory (the
Gram area leaves shared memory where it would cost the kernel without
Anderson, ``ops/qp_kernel.py:anderson_placement``).  The JAX package's TPU
kernels had neither bound.  Here the same numpy inputs, float64, go through
the JAX kernels in interpret mode on the CPU and through the port's plain
versions of the same kernels:

* K6 on random band QPs at internal block 136 (T = 2, a loose row), cold
  and warm-started;
* the OSQP control class at 50 states and 25 inputs (declared stage block
  75, internal block 152; horizon 3, so n = 225 padded to 304, T = 2)
  through ``qp_solve_batch(impl="kernel")`` at OSQP's bars;
* K7 at internal block 136, its iterates and nine stats rows;
* K3 and K6 (internal block 8) with Anderson at memories 33 and 40, in
  chunks of 2 with rho every 120 iterations, so that the ring fills and
  wraps before a rho change empties it.

Tolerances as ``tests/test_torch_btd_wide.py``'s: statuses, iteration and
rho-update counts equal; x, y, z to atol 1e-9; the adaptive rho to rtol
1e-6 (ROADMAP Queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel_btd import btd_step_kernel as jax_btd_step
from sqp_solver_tpu.ops.qp_kernel_btd import qp_solve_kernel_btd as jax_qp_btd
from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus
from sqp_solver_tpu_torch.testing import (
    btd_qp_inputs,
    btd_step_inputs,
    control_qp_inputs,
    qp_inputs,
)

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
BTD = dict(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
           adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
           linear_solver="schur_block_tridiag")
# Anderson past memory 32: chunks of 2 and rho every 120 iterations (60
# chunks an epoch), tolerances the problems do not reach in the 90
# iterations, so that the solve runs on past the chunk at which the ring
# wraps (84 iterations at memory 40)
AA_LONG = dict(alpha=1.6, eps_abs=1e-7, eps_rel=1e-7, max_iter=90, check_termination=2,
               adaptive_rho=True, adaptive_rho_interval=120, schedule="fixed",
               acceleration="anderson")


def _jax_qp(a):
    return JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))


def _port_qp(a):
    return interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")


def _states(a, warm):
    if not warm:
        return None, None
    return (JaxQPState(*(jnp.asarray(a[k]) for k in "xzy")),
            interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu"))


def _assert_qp_equal(pr, jr):
    p = interop.qp_result_to_numpy(pr)
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(p[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(p["rho_estimate"], np.asarray(jr.info.rho_estimate), rtol=1e-6)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k], np.asarray(getattr(jr, k)), atol=ATOL, rtol=0,
                                   err_msg=k)
    return p


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_k6_at_internal_block_136_matches_jax(warm):
    """Random band QPs at T = 2 blocks of 136 (m = 48 rows, a loose one),
    cold and warm-started: K6's plain version, on the wide route's band
    rows, against the JAX kernel."""
    a = btd_qp_inputs(2, 2, 136, 48, seed=136, loose_row=True)
    s = dict(BTD, block_size=136)
    jst, pst = _states(a, warm)
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s), state=jst)
    pr = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s), state=pst)
    assert qb.is_wide(136)
    p = _assert_qp_equal(pr, jr)
    assert (p["status"] == QPStatus.SOLVED).all()


def test_control_class_at_50_states_matches_jax():
    """The OSQP control class at 50 states and 25 inputs (horizon 3: n = 225,
    150 dynamics equalities, m = 375) through ``qp_solve_batch(impl=
    "kernel")`` with the declared stage block 75 at OSQP's bars (1e-3):
    internal block 152, n padded to 304, the structured kernel's route in
    both packages."""
    a = control_qp_inputs(2, horizon=3, nx=50, nu=25, seed=0)
    s = dict(BTD, block_size=75, eps_abs=1e-3, eps_rel=1e-3, max_iter=400, rho=1.0)
    jr = jax_qp_solve_batch(_jax_qp(a), JaxQPSettings(**s), impl="kernel")
    pr = qp_solve_batch(_port_qp(a), QPSettings(**s), impl="kernel")
    assert qb.btd_internal_block(75) == 152 and pr.x.shape == (2, 225)
    p = _assert_qp_equal(pr, jr)
    assert (p["status"] == QPStatus.SOLVED).all()


def test_k7_at_internal_block_136_matches_jax():
    """K7 at bb = 136 (T = 2, m = 48), a carried rho on every second problem
    and the last problem inactive: iterates and the nine stats rows."""
    t = btd_step_inputs(3, 2, 136, 48, seed=11)
    s = dict(BTD, block_size=136, max_iter=50)
    msk = np.zeros((8, 3))
    msk[2] = t["active"]
    msk[3] = t["rho_in"]
    args = [interop.band_to_kernel_layout(torch.as_tensor(t[k])) for k in ("pd", "pe")]
    args += [np.moveaxis(t[k], 0, -1) for k in ("J", "g", "l", "u")]
    args += [msk] + [np.moveaxis(t[k], 0, -1) for k in ("x", "z", "y")]
    jp, jz, jy, st = jax_btd_step(*(jnp.asarray(v) for v in args), JaxQPSettings(**s))
    tt = {k: torch.as_tensor(v) for k, v in t.items()}
    out = qb.btd_step_kernel(tt["pd"], tt["pe"], tt["J"], tt["g"], tt["l"], tt["u"],
                             tt["active"], tt["x"], tt["z"], tt["y"], QPSettings(**s),
                             rho_in=tt["rho_in"])
    for name, a, b in (("p", out.x, jp), ("z", out.z, jz), ("y", out.y, jy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).T, atol=ATOL, rtol=0, err_msg=name)
    rows = (out.done, out.iter, out.res_prim, out.res_dual, out.fail, out.rho_updates,
            out.rho_estimate, out.infs, out.rho_factor)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r.double().numpy(), np.asarray(st)[i], rtol=1e-6,
                                   atol=1e-12, err_msg=f"stats row {i}")
    assert out.band.all() and int(out.iter[0]) > 0 and int(out.iter[-1]) == 0


@pytest.mark.parametrize("memory", [33, 40])
@pytest.mark.parametrize("kernel", ["K3", "K6"])
def test_anderson_past_memory_32_matches_jax(kernel, memory):
    """Warm-started random QPs (K3: n = 16, m = 24; K6: band QPs at T = 4
    blocks of 8, m = 24), a loose row each, with Anderson at memories 33 and
    40: the 45 chunks of the first epoch push more pairs than the ring
    holds, so that it wraps (every problem runs past the chunk at which it
    does)."""
    if kernel == "K3":
        a = qp_inputs(2, 16, 24, seed=memory, loose_row=True)
        s = dict(AA_LONG, anderson_memory=memory)
    else:
        a = btd_qp_inputs(2, 4, 8, 24, seed=memory, loose_row=True)
        s = dict(AA_LONG, anderson_memory=memory, linear_solver="schur_block_tridiag",
                 block_size=8)
    jst, pst = _states(a, True)
    jr = jax_qp_solve_batch(_jax_qp(a), JaxQPSettings(**s), state=jst, impl="kernel")
    pr = qp_solve_batch(_port_qp(a), QPSettings(**s), state=pst, impl="kernel")
    p = _assert_qp_equal(pr, jr)
    assert (p["iter"] >= 2 * (memory + 2)).all()
