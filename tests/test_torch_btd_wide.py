"""Internal blocks wider than a warp, and K2's factor reuse, against the JAX package.

The port's plain versions of the structured kernels (K6, K7) at internal
blocks 40 and 48 (which the card runs through ``csrc/qp_kernel_btd_wide.cu``)
and of the polish-KKT kernel (K2) with its factor-reuse inputs, against the
JAX package's kernels in interpret mode on the CPU, float64, on the same
numpy inputs.

Tolerances.  Statuses, iteration and rho-update counts are equal; x, y and
z agree to atol 1e-9 (float64 rounding summed in another order); the
adaptive rho, a ratio of residual norms near the float64 floor, to rtol
1e-6.  K2 with reuse: flags equal, x, nu and li to atol 1e-9.  The JAX
kernel decides reuse per tile of lanes and the port per problem; where a
problem's mask changed, JAX refactors every problem of the tile, which
gives the same L^-1 as the reused one when it came from the same (H, J).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel import polish_kkt_kernel as jax_polish
from sqp_solver_tpu.ops.qp_kernel_btd import btd_step_kernel as jax_btd_step
from sqp_solver_tpu.ops.qp_kernel_btd import qp_solve_kernel_btd as jax_qp_btd
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus
from sqp_solver_tpu_torch.testing import (
    btd_qp_inputs,
    btd_step_inputs,
    control_qp_inputs,
    polish_inputs,
)

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
BTD = dict(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
           adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
           linear_solver="schur_block_tridiag")
INFO = ("status", "iter", "rho_updates")


def _jax_qp(a):
    return JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))


def _port_qp(a):
    return interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")


def _assert_qp_equal(pr, jr):
    p = interop.qp_result_to_numpy(pr)
    for k in INFO:
        np.testing.assert_array_equal(p[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(p["rho_estimate"], np.asarray(jr.info.rho_estimate), rtol=1e-6)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k], np.asarray(getattr(jr, k)), atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("bb,warm,anderson", [(40, False, False), (40, True, False),
                                              (40, False, True), (48, False, False),
                                              (48, True, False)])
def test_k6_wide_blocks_match_jax(bb, warm, anderson):
    """Random band QPs at T = 2 blocks of 40 or 48 (m = 48 rows, a loose
    one), cold and warm-started, and at 40 with Anderson acceleration:
    K6's plain version against the JAX kernel."""
    a = btd_qp_inputs(3, 2, bb, 48, seed=bb, loose_row=True)
    s = dict(BTD, block_size=bb)
    if anderson:
        s.update(check_termination=10, acceleration="anderson", anderson_memory=3)
    jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy")) if warm else None
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s), state=jst)
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu") if warm else None
    pr = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**s), state=pst)
    _assert_qp_equal(pr, jr)
    assert (pr.info.status.numpy() == QPStatus.SOLVED).all()


def test_k7_wide_block_matches_jax():
    """K7 at bb = 40 (T = 2, m = 48), a carried rho on every second problem
    and the last problem inactive: iterates and the nine stats rows."""
    t = btd_step_inputs(3, 2, 40, 48, seed=11)
    s = dict(BTD, block_size=40, max_iter=100)
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
    assert int(out.iter[0]) > 0 and int(out.iter[-1]) == 0


def test_control_arm_declared_block_route_matches_jax():
    """The OSQP control class's 6-DOF arm (12 states, 6 inputs) at horizon 4
    through ``qp_solve_batch(impl="kernel")`` with the declared stage block
    18: internal block 40, n = 72 padded to 80, 48 dynamics equalities."""
    a = control_qp_inputs(3, horizon=4, seed=0)
    s = dict(BTD, block_size=18, eps_abs=1e-4, eps_rel=1e-4, max_iter=400, rho=1.0)
    jr = jax_qp_btd(_jax_qp(a), JaxQPSettings(**s))
    pr = qp_solve_batch(_port_qp(a), QPSettings(**s), impl="kernel")
    assert qb.btd_internal_block(18) == 40 and pr.x.shape == (3, 72)
    _assert_qp_equal(pr, jr)
    assert (pr.info.status.numpy() == QPStatus.SOLVED).all()


def _jt(a):
    return jnp.asarray(np.moveaxis(np.asarray(a, dtype=np.float64), 0, -1))


def _polish_pair(a, act_prev=None, li=None, fail=None):
    """K2 in both packages on ``a``, with reuse where ``act_prev`` is given
    (``li`` and ``fail``: each package's own previous outputs)."""
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    port = qk.polish_kkt_kernel(
        t["H"], t["J"], t["act"], t["r1"], t["b"], t["nu0"], delta=1e-2, sweeps=4,
        x0=t["x0"], act_prev=None if act_prev is None else torch.as_tensor(act_prev),
        li_prev=None if li is None else li[0], fail_prev=None if fail is None else fail[0])
    kw = {}
    if act_prev is not None:
        kw = dict(actt_prev=_jt(act_prev), li_prev=li[1],
                  fail_prev=None if fail is None else jnp.asarray(fail[1]))
    dx, nu, jfail, jli = jax_polish(_jt(a["H"]), _jt(a["J"]), _jt(a["act"]), _jt(a["r1"]),
                                    _jt(a["b"]), _jt(a["nu0"]), delta=1e-2, sweeps=4,
                                    x0t=_jt(a["x0"]), **kw)
    jfail = np.asarray(jfail) > 0.5
    np.testing.assert_array_equal(port.fail.numpy(), jfail)
    good = ~np.isnan(port.x.numpy()).any(axis=1)
    for name, p, j in (("x", port.x, np.asarray(dx).T), ("nu", port.nu, np.asarray(nu).T),
                       ("li", port.li, np.moveaxis(np.asarray(jli), -1, 0))):
        np.testing.assert_allclose(p.numpy()[good], j[good], atol=ATOL, rtol=0, err_msg=name)
    return port, (jli, np.asarray(jfail, dtype=np.float64))


@pytest.mark.parametrize("case", ["unchanged", "one_changed", "fail_kept"])
def test_polish_factor_reuse_matches_jax(case):
    """A first pass, then a second on the same (H, J) that reuses its L^-1:
    every mask unchanged; one problem's mask changed (JAX refactors the
    whole tile, the port that problem only, so problem 0's clamped pivot
    (an indefinite H) is kept by ``fail_prev`` in the port and found again
    in JAX); every mask unchanged with ``fail_prev``, which keeps problem
    0's clamped pivot (without it the reused factor reports none, as in
    JAX)."""
    a = polish_inputs(4, 8, 10, seed=6)
    first, jfirst = _polish_pair(a)
    assert bool(first.fail[0]) and not first.fail[1:].any()
    b = dict(a, r1=a["r1"] + 0.3, b=np.where(a["act"], a["b"] - 0.2, 0.0))
    act_prev = a["act"].copy()
    if case == "one_changed":
        act_prev[2, 0] = not act_prev[2, 0]
    li = (first.li, jfirst[0])
    fail = None if case == "unchanged" else (first.fail, jfirst[1])
    second, _ = _polish_pair(b, act_prev, li, fail)
    fresh = qk.polish_kkt_kernel(*(torch.as_tensor(b[k]) for k in ("H", "J", "act", "r1", "b",
                                                                    "nu0")),
                                 delta=1e-2, sweeps=4, x0=torch.as_tensor(b["x0"]))
    assert bool(fresh.fail[0])
    assert bool(second.fail[0]) == (case != "unchanged") and not second.fail[1:].any()
    # reuse of the same (H, J)'s factor gives the fresh solve's answer
    np.testing.assert_allclose(second.x[1:].numpy(), fresh.x[1:].numpy(), atol=ATOL, rtol=0)


def test_polish_reuse_needs_the_previous_factor():
    a = {k: torch.as_tensor(v) for k, v in polish_inputs(2, 4, 5, seed=1).items()}
    args = [a[k] for k in ("H", "J", "act", "r1", "b", "nu0")]
    with pytest.raises(ValueError, match="li_prev"):
        qk.polish_kkt_kernel(*args, act_prev=a["act"])
    with pytest.raises(ValueError, match="li_prev"):
        qk.polish_kkt_reference(*args, act_prev=a["act"])
    with pytest.raises(ValueError, match="li_prev"):
        jax_polish(*(_jt(v.numpy()) for v in args), actt_prev=_jt(a["act"].numpy()))
    # without act_prev the other two are not read, as in JAX
    plain = qk.polish_kkt_kernel(*args)
    same = qk.polish_kkt_kernel(*args, li_prev=torch.zeros(2, 4, 4), fail_prev=a["act"][:, 0])
    assert torch.equal(plain.x, same.x) and torch.equal(plain.fail, same.fail)


def test_wide_route_refuses_blocks_past_the_kernels():
    """The internal blocks the CUDA kernels take: 8, 16, 24, 32 (narrow),
    every other multiple of 8 (wide: 40 to 128, and past 128, as 136, 152
    and 256, since the wide kernel's sweep chains take rows in rounds);
    an internal block that is no multiple of 8 raises.  On the CPU every
    block runs the plain version and counts no launch."""
    assert [qb.is_wide(bb) for bb in (8, 32, 40, 64, 128, 136, 152, 256)] == [
        False, False, True, True, True, True, True, True]
    for bb in (12, 0):
        with pytest.raises(ValueError, match="multiples of 8"):
            qb.is_wide(bb)
    before = (qb.qp_solve_btd_launches, qb.qp_solve_btd_wide_launches,
              qb.btd_step_launches, qb.btd_step_wide_launches)
    for bb in (136, 256):
        a = btd_qp_inputs(2, 1, bb, 20, seed=3)
        r = qb.qp_solve_kernel_btd(_port_qp(a), QPSettings(**dict(BTD, block_size=bb,
                                                                   max_iter=50)))
        assert r.x.shape == (2, bb) and bool(torch.isfinite(r.x).all())
    assert (qb.qp_solve_btd_launches, qb.qp_solve_btd_wide_launches, qb.btd_step_launches,
            qb.btd_step_wide_launches) == before
