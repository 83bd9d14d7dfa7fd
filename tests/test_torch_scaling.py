"""Ruiz scaling (``qp/scaling.py``) on every tier of the port against the
JAX package, float64 on the CPU.

* ``ruiz_equilibrate``'s factors (d, e, c) and scaled operands, the
  classification-invariance correction included, within 1e-12;
* ``solve_with_scaling`` through the vmap, kernel (K3) and fused (K5) QP
  tiers, with ``check_comp_slack`` scored at the unscaled rescore:
  statuses and counts equal, x, y, z within 1e-9;
* the scaled SQP tiers: the kernel tier (K1 with the BFGS update outside
  it and the SOC re-solve reusing the first solve's factors) and the
  fused tier (each subproblem equilibrated afresh), statuses and counts
  equal, x and lambda within 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.families import huber_qp_batch as jax_huber
from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.scaling import ruiz_equilibrate as jax_ruiz
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models.families import huber_qp_batch
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.admm_batched import qp_solve_fused
from sqp_solver_tpu_torch.qp.scaling import (
    rescore,
    ruiz_equilibrate,
    scale_state,
    unscale_result,
)
from sqp_solver_tpu_torch.qp.types import QPResult, QPSettings, QPState, QPStatus
from sqp_solver_tpu_torch.testing import qp_inputs

from test_torch_slice import HEADLINE, _solve_both

LEAVES = ("P", "q", "A", "l", "u")
# the families leg's settings (bench.py:1061-1065), comp slack scored
FAMILY = dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=300, check_termination=25,
              adaptive_rho=True, adaptive_rho_interval=50, polish=True, scaling=10,
              schedule="fixed", check_comp_slack=True)


def _badly_scaled(kind):
    """Random QPs with a loose row and an equality row, rows and columns
    scaled over six decades; ``classes``: narrow inequality gaps on big
    rows and a large finite bound, which the sweeps would push across
    RHO_TOL and LOOSE_BOUNDS_THRESH without the correction."""
    a = qp_inputs(4, 6, 8, seed=9, equality_row=True, loose_row=True)
    a["A"][:, 1] *= 1e3
    a["A"][:, :, 2] *= 1e-3
    a["P"] *= 30.0
    if kind == "classes":
        mid = 0.5 * (a["l"][:, 3] + a["u"][:, 3])
        a["l"][:, 3], a["u"][:, 3] = mid - 2e-4, mid + 2e-4
        a["A"][:, 3] *= 1e-3
        a["l"][:, 4] = -1e15
    return a


@pytest.mark.parametrize("kind", ["random", "classes"])
def test_ruiz_equilibrate_matches_jax(kind):
    a = _badly_scaled(kind)
    js, jsc = jax_ruiz(JaxQP(*(jnp.asarray(a[k]) for k in LEAVES)), 10)
    ps, psc = ruiz_equilibrate(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"), 10)
    for k in LEAVES:
        np.testing.assert_allclose(getattr(ps, k).numpy(), np.asarray(getattr(js, k)),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    for k in ("d", "e", "c"):
        np.testing.assert_allclose(getattr(psc, k).numpy(), np.asarray(getattr(jsc, k)),
                                   rtol=1e-12, atol=0, err_msg=k)
    assert psc.e.numpy().max() / psc.e.numpy().min() > 10.0  # the scaling did something
    # one problem without the batch axis
    one, sc1 = ruiz_equilibrate(interop.qp_from_arrays(*(a[k][1] for k in LEAVES),
                                                       device="cpu"), 10)
    np.testing.assert_allclose(one.A.numpy(), ps.A[1].numpy(), rtol=1e-14, atol=0)
    assert sc1.c.shape == ()


def test_scale_state_round_trip_and_rescore():
    a = _badly_scaled("random")
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    _, sc = ruiz_equilibrate(pq, 10)
    st = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu")
    back = unscale_result(QPResult(*(getattr(scale_state(st, sc), k) for k in ("x", "y", "z")),
                                   info=None), sc)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(back, k).numpy(), a[k], rtol=1e-14, atol=1e-15)
    # the rescore judges the original residuals: an exact solution is
    # SOLVED whatever the scaled status said, certificates pass through
    res = qp_solve_batch(pq, QPSettings(eps_abs=1e-8, eps_rel=1e-8, max_iter=4000,
                                        adaptive_rho=True))
    assert (res.info.status == QPStatus.SOLVED).all()
    info = dataclasses.replace(res.info, status=torch.tensor([1, 5, 3, 1], dtype=torch.int32))
    out = rescore(pq, QPResult(x=res.x, y=res.y, z=res.z, info=info),
                  QPSettings(eps_abs=1e-6, eps_rel=1e-6))
    assert out.info.status.tolist() == [0, 5, 3, 0]


@pytest.mark.parametrize("impl", ["vmap", "kernel", "fused"])
def test_solve_with_scaling_matches_jax(impl):
    """The huber family (the OSQP class that stalls unscaled) through each
    tier under scaling, polish and the comp-slack rescore."""
    jq, _ = jax_huber(4, 4, 8, seed=2, dtype=jnp.float64)
    pq, _ = huber_qp_batch(4, 4, 8, seed=2, dtype=torch.float64, device="cpu")
    jr = jax_qp_solve_batch(jq, JaxQPSettings(**FAMILY), impl=impl)
    pr = qp_solve_batch(pq, QPSettings(**FAMILY), impl=impl)
    port = interop.qp_result_to_numpy(pr)
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(port[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z", "res_prim", "res_dual"):
        want = np.asarray(getattr(jr, k) if k in "xyz" else getattr(jr.info, k))
        np.testing.assert_allclose(port[k], want, atol=1e-9, rtol=0, err_msg=k)
    assert (port["status"] == QPStatus.SOLVED).sum() >= 2


def test_fused_tier_refuses_scaling_outside_the_pipeline():
    """As the JAX ``qp_solve_fused``: scaling only through qp_solve_batch."""
    a = qp_inputs(2, 3, 4, seed=1)
    with pytest.raises(ValueError, match="scaling"):
        qp_solve_fused(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"),
                       QPSettings(scaling=5))


@pytest.mark.parametrize("qp_impl,soc", [("kernel", False), ("kernel", True), ("fused", True)],
                         ids=["kernel", "kernel_soc", "fused_soc"])
def test_scaled_sqp_tiers_match_jax(qp_impl, soc):
    settings = dataclasses.replace(
        HEADLINE, qp_impl=qp_impl, second_order_correction=soc,
        qp=dataclasses.replace(HEADLINE.qp, scaling=10))
    _, jr, pp, pr = _solve_both(4, 6, 2, settings, np.float64)
    for k in ("status", "iter", "qp_solver_iter"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=1e-8, rtol=0)
    assert (pr.info.status.numpy() == 0).sum() >= 2


def test_soc_rescaling_reuses_the_first_solves_factors():
    """The kernel tier's SOC re-solve rescales with the first solve's
    (d, e, c), carried in from the JAX package's own equilibration: on a
    problem whose rows cross no class boundary it reproduces the
    equilibrated operands, so the reused Minv fits the operator."""
    from sqp_solver_tpu_torch.sqp.common import SubproblemInputs
    from sqp_solver_tpu_torch.sqp.solver_kernel import _scaled_operands

    a = qp_inputs(4, 6, 8, seed=11)
    a["A"][:, 2] *= 1e2
    js, jsc = jax_ruiz(JaxQP(*(jnp.asarray(a[k]) for k in LEAVES)), 10)
    scale = interop.scaling_from_numpy(np.asarray(jsc.d), np.asarray(jsc.e),
                                       np.asarray(jsc.c), device="cpu")
    t = {k: torch.as_tensor(a[k]) for k in a}
    s = SubproblemInputs(k=1, active=None, x=None, grad_obj=t["q"], c_val=None, J=t["A"],
                         l=None, u=None, B=None, step_prev=None, delta_grad_L=None, reset=None,
                         upd=None, warm=None, c_of=None)
    warm = QPState(x=t["x"], z=t["z"], y=t["y"])
    P, A, q, l, u, st, _ = _scaled_operands(t["P"], s, t["l"], t["u"], warm, 10, scale)
    for got, k in ((P, "P"), (A, "A"), (q, "q"), (l, "l"), (u, "u")):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(js, k)), rtol=1e-13,
                                   atol=1e-13, err_msg=k)
    np.testing.assert_allclose(st.y.numpy(), a["y"] * np.asarray(jsc.c)[:, None]
                               / np.asarray(jsc.e), rtol=1e-14)
