"""The port's reference-semantics SQP tier against the JAX package.

The JAX ``sqp_solve`` (one problem, or ``sqp_solve_batch(impl="vmap")``)
and the port's ``sqp_solve`` / ``sqp_solve_batch(impl="vmap")`` run the
reference fixtures and a small sphere-cap batch in float64, with and
without the second-order correction: statuses, outer and accumulated QP
iteration counts equal, x and lambda within 1e-8.  Also the sustained
sequences over ``impl="vmap"``.

Cases where the JAX package's own per-problem and ``vmap`` runs part
(rounding amplified by an infeasible first subproblem or an
ill-conditioned BFGS estimate, ROADMAP Queue 3) are held against the
reference goldens in ``tests/test_torch_conformance.py`` instead.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models import problems as jax_problems
from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch as jax_sphere_cap
from sqp_solver_tpu.parallel.batch import sqp_solve_batch as jax_sqp_solve_batch
from sqp_solver_tpu.qp import qp_solve_sequence as jax_qp_solve_sequence
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.sqp import sqp_solve as jax_sqp_solve
from sqp_solver_tpu.sqp import sqp_solve_sequence as jax_sqp_solve_sequence
from sqp_solver_tpu.sqp.types import SQPSettings as JaxSQPSettings
from sqp_solver_tpu_torch.models import benchmark as port_models
from sqp_solver_tpu_torch.models import problems
from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings, QPStatus, qp_solve_sequence
from sqp_solver_tpu_torch.sqp import SQPSettings, SQPStatus, sqp_solve, sqp_solve_sequence

from test_torch_serving import _fleet, _jax_fleet, _plant0, _port_fleet, _port_nlp

TOL = 1e-8
# (fixture, constructor arguments, x0, lam0, second-order correction, polish)
FIXTURES = {
    "simple_nlp": ("simple_nlp", (), [1.2, 0.1], [0.0] * 3, False, False),
    "simple_nlp_soc_polish": ("simple_nlp", (), [1.2, 0.1], [0.0] * 3, True, True),
    "simple_nlp_infeasible_start": ("simple_nlp", (), [2.0, -1.0], [1.0] * 3, False, False),
    "simple_qp_nlp_soc": ("simple_qp_nlp", (), [0.0, 0.0], [0.0] * 3, True, False),
    "constrained_rosenbrock_2d_polish": ("constrained_rosenbrock_2d", (), [0.0, 0.0],
                                         [0.0] * 2, False, True),
    "rosenbrock_box_3_soc": ("rosenbrock_box", (3,), [0.0, 0.0, 0.0], [0.0] * 3, True, False),
    "simple_nlp2_soc": ("simple_nlp2", (), [1.2, 0.1], [0.0], True, False),
}


def _jax_settings(s: SQPSettings) -> JaxSQPSettings:
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.name != "qp"}
    return JaxSQPSettings(**fields, qp=JaxQPSettings(**dataclasses.asdict(s.qp)))


def _assert_same(pr, jr):
    for k in ("status", "iter", "qp_solver_iter"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=TOL, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", list(FIXTURES))
def test_sqp_solve_fixture_matches_jax(case):
    name, args, x0, lam0, soc, polish = FIXTURES[case]
    s = SQPSettings(second_order_correction=soc, polish=polish)
    jr = jax_sqp_solve(getattr(jax_problems, name)(*args), jnp.asarray(x0), jnp.asarray(lam0),
                       _jax_settings(s))
    pr = sqp_solve(getattr(problems, name)(*args, device="cpu"),
                   torch.tensor(x0, dtype=torch.float64), torch.tensor(lam0, dtype=torch.float64), s)
    assert pr.x.shape == (len(x0),) and pr.info.status.shape == ()
    _assert_same(pr, jr)
    assert int(pr.info.status) == SQPStatus.SOLVED


@pytest.mark.parametrize("soc", [False, True], ids=["no_soc", "soc"])
def test_sqp_solve_batch_vmap_sphere_cap_matches_jax(soc):
    """B = 4, n = 6, batched bounds and parameters (``l.ndim == x0.ndim``),
    the family's derivative hooks, KKT termination; a SOLVED problem meets
    the closed form (with SOC two of the four stall at max_iter in both
    packages)."""
    s = SQPSettings(max_iter=20, second_order_correction=soc, polish=True, polish_passes=1,
                    termination="kkt", eps_prim=1e-6, eps_dual=1e-6)
    jp, jx0 = jax_sphere_cap(4, 6, seed=2, dtype=jnp.float64)
    pp, px0 = port_models.sphere_cap_nlp_batch(4, 6, seed=2, dtype=torch.float64, device="cpu")
    jr = jax_sqp_solve_batch(jp, jx0, None, _jax_settings(s), impl="vmap")
    pr = sqp_solve_batch(pp, px0, None, s)  # impl="vmap", the default
    _assert_same(pr, jr)
    solved = pr.info.status.numpy() == SQPStatus.SOLVED
    assert solved.sum() >= 2
    assert np.abs(pr.x.numpy() - port_models.sphere_cap_solution(pp))[solved].max() < 1e-6


def test_sqp_solve_batch_vmap_shared_bounds_kkt_matches_jax():
    """A batch of starts of one fixture (shared l, u (m,)) under KKT
    termination, against ``jax.vmap`` of the JAX per-problem solve."""
    s = SQPSettings(termination="kkt", eps_prim=1e-6, eps_dual=1e-6)
    x0 = np.array([[1.2, 0.1], [0.5, 0.5], [1.0, 1.4]])
    jr = jax_sqp_solve_batch(jax_problems.simple_nlp(), jnp.asarray(x0), jnp.zeros((3, 3)),
                             _jax_settings(s), impl="vmap")
    pr = sqp_solve_batch(problems.simple_nlp(device="cpu"), torch.as_tensor(x0),
                         torch.zeros((3, 3), dtype=torch.float64), s, impl="vmap")
    _assert_same(pr, jr)
    np.testing.assert_allclose(pr.x.numpy(), np.tile(problems.SIMPLE_NLP_SOLUTION, (3, 1)),
                               atol=1e-5)


def test_qp_solve_sequence_vmap_matches_jax():
    """K = 3 warm-started steps of the MPC fleet through impl="vmap"."""
    mpc = dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200, check_termination=25,
               adaptive_rho=True, adaptive_rho_interval=50)
    f = _fleet()
    x0 = _plant0()
    pm, pa = _port_fleet()
    jm, ja = _jax_fleet(f)
    (px, pit, pst, prms), pcarry, pstate = qp_solve_sequence(
        pm, pa, torch.as_tensor(x0), 3, QPSettings(**mpc), impl="vmap")
    (jx, jit, jst, jrms), jcarry, jstate = jax_qp_solve_sequence(
        jm, ja, jnp.asarray(x0), 3, JaxQPSettings(**mpc), impl="vmap")
    np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst))
    assert (pst.numpy() == QPStatus.SOLVED).all()
    for got, want in ((px, jx), (pcarry, jcarry), (pstate.y, jstate.y), (prms, jrms)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=0)


def test_sqp_solve_sequence_vmap_matches_jax():
    """A cold solve hands (x, lam) to K = 2 warm steps through impl="vmap"."""
    n, batch = 6, 4
    s = SQPSettings(max_iter=20, polish=True, polish_passes=1)
    jp, jx0 = jax_sphere_cap(batch, n, seed=5, dtype=jnp.float64)
    r0 = np.array(jp.params)
    jset = _jax_settings(s)

    def jmake(r):
        l = jnp.zeros((batch, n + 1))
        u = jnp.concatenate([(r ** 2)[:, None], jnp.ones((batch, n))], axis=1)
        return dataclasses.replace(jp, l=l, u=u, params=r), jnp.full((batch, n), 0.25)

    step = dataclasses.replace(s, max_iter=2)
    jres0 = jax_sqp_solve_batch(jmake(jnp.asarray(r0))[0], jx0, None, jset, impl="vmap")
    (jxs, jsts), _, (_, jlam_f) = jax_sqp_solve_sequence(
        jmake, lambda r, res: (0.98 * r, (res.x, res.info.status)), 0.98 * jnp.asarray(r0), 2,
        _jax_settings(step), impl="vmap", warm0=(jres0.x, jres0.lam))
    make_nlp, _ = _port_nlp(n)
    pr0 = torch.as_tensor(r0)
    pres0 = sqp_solve_batch(make_nlp(pr0)[0], torch.as_tensor(np.array(jx0)), None, s)
    (pxs, psts), _, (_, plam_f) = sqp_solve_sequence(
        make_nlp, lambda r, res: (0.98 * r, (res.x, res.info.status)), 0.98 * pr0, 2, step,
        impl="vmap", warm0=(pres0.x, pres0.lam))
    np.testing.assert_array_equal(psts.numpy(), np.asarray(jsts))
    np.testing.assert_allclose(pxs.numpy(), np.asarray(jxs), atol=TOL, rtol=0)
    np.testing.assert_allclose(plam_f.numpy(), np.asarray(jlam_f), atol=TOL, rtol=0)
