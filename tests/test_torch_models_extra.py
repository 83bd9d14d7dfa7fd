"""The multi-outer NLP families (``models/benchmark.py``: the exponential
chain and the ball-constrained Rosenbrock) against the JAX package,
float64.

The JAX package draws them with ``jax.random``; the port's ``_device``
generators draw from a ``torch.Generator`` (the same distributions, not
the same draws, as ROADMAP Queue 3 records for the families).  So the
port's problems are built here from the JAX package's draws
(``exp_chain_problem``, ``rosenbrock_problem``) and solved on the fused
SQP tier with a few outers: statuses and x equal the JAX package's to
1e-8, and the float64 KKT residual functions give the JAX functions'
numbers.  At the card leg's settings (adaptive rho, the K1 tier) the
statuses are equal and every SOLVED problem meets its float64 KKT
residuals.  The device generators are checked for their ranges, shapes
and seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models import benchmark as jbm
from sqp_solver_tpu.parallel.batch import sqp_solve_batch as jax_sqp_solve_batch
from sqp_solver_tpu.qp import QPSettings as JaxQPSettings
from sqp_solver_tpu.sqp import SQPSettings as JaxSQPSettings
from sqp_solver_tpu_torch.models import benchmark as pbm
from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings
from sqp_solver_tpu_torch.sqp import SQPSettings

B, N = 4, 8
# no adaptive rho: the Rosenbrock's first inner QPs end unconverged, where
# the rho estimates, equal to ~1e-9 relative in the two packages (ROADMAP
# Queue 3), part the iterates by ~1e-6; at a fixed rho they agree to 1e-13
QP = dict(alpha=1.6, eps_abs=1e-7, eps_rel=1e-7, max_iter=400, check_termination=10,
          warm_start=True, adaptive_rho=False)
FAMILIES = {
    # family: (JAX generator, port constructor, port residuals, JAX residuals, outers)
    "exp_chain": (jbm.exp_chain_nlp_batch_device, pbm.exp_chain_problem,
                  pbm.exp_chain_kkt_residuals, jbm.exp_chain_kkt_residuals, 6),
    "rosenbrock": (jbm.rosenbrock_nlp_batch_device, pbm.rosenbrock_problem,
                   pbm.rosenbrock_kkt_residuals, jbm.rosenbrock_kkt_residuals, 6),
}


def _settings(pkg_sqp, pkg_qp, outers):
    return pkg_sqp(max_iter=outers, eps_prim=1e-6, eps_dual=1e-6, termination="kkt",
                   schedule="fixed", polish=True, polish_passes=2, line_search_max_iter=8,
                   qp=pkg_qp(**QP, schedule="fixed"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_from_jax_draws_solves_as_jax(family):
    jgen, make, res_port, res_jax, outers = FAMILIES[family]
    jp, jx0 = jgen(jax.random.PRNGKey(3), B, N, jnp.float64)
    pp = make(*(torch.tensor(np.asarray(getattr(jp, k))) for k in ("l", "u", "params")))
    px0 = torch.tensor(np.asarray(jx0))
    jr = jax_sqp_solve_batch(jp, jx0, None, _settings(JaxSQPSettings, JaxQPSettings, outers),
                             impl="fused")
    pr = sqp_solve_batch(pp, px0, None, _settings(SQPSettings, QPSettings, outers),
                         impl="fused")
    np.testing.assert_array_equal(pr.info.status.numpy(), np.asarray(jr.info.status))
    np.testing.assert_array_equal(pr.info.iter.numpy(), np.asarray(jr.info.iter))
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=1e-8, rtol=0)
    # the objective and constraint callables equal the JAX ones
    f_j = jax.vmap(jp.objective)(jnp.asarray(np.asarray(jx0)), jp.params)
    np.testing.assert_allclose(pp.objective(px0, pp.params).numpy(), np.asarray(f_j),
                               rtol=1e-13)
    # the residual functions give the JAX functions' numbers on the port's
    # tensors and at the JAX solution
    for got, want in zip(res_port(pp, pr.x, pr.lam), res_jax(jp, jr.x, jr.lam)):
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)
    for got, want in zip(res_port(pp, np.asarray(jr.x), np.asarray(jr.lam)),
                         res_jax(jp, jr.x, jr.lam)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_device_generator(family):
    gen = getattr(pbm, f"{family}_nlp_batch_device")
    p1, x1 = gen(5, 64, N, dtype=torch.float64, device="cpu")
    p2, x2 = gen(5, 64, N, dtype=torch.float64, device="cpu")
    assert torch.equal(x1, x2) and torch.equal(p1.params, p2.params)
    r = p1.u[:, 0].sqrt()
    sqn = np.sqrt(N)
    lo, hi, box, x_lo = ((0.35, 0.6, 3.0, 0.0) if family == "exp_chain"
                         else (0.6, 0.85, 2.0, -1.2))
    assert (r >= lo * sqn - 1e-12).all() and (r <= hi * sqn + 1e-12).all()
    assert (p1.l[:, 0] == 0).all() and (p1.u[:, 1:] == box).all() and (p1.l[:, 1:] == -box).all()
    assert x1.shape == (64, N) and (x1 >= x_lo).all()
    if family == "exp_chain":
        c, b = p1.params[:, :N], p1.params[:, N:]
        assert ((c >= 0.5) & (c <= 1.5)).all() and ((b >= 1.0) & (b <= 3.0)).all()
        assert (x1 <= 0.01).all()
    else:
        assert (x1[:, 1::2] >= 1.0).all() and (x1[:, ::2] <= -1.15).all()
    g = torch.Generator().manual_seed(5)
    p3, _ = gen(g, 64, N, dtype=torch.float64)
    assert torch.equal(p3.params, p1.params)



def _jax_settings(s: SQPSettings) -> JaxSQPSettings:
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.name != "qp"}
    return JaxSQPSettings(**fields, qp=JaxQPSettings(**dataclasses.asdict(s.qp)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_at_the_card_leg_settings_meets_its_kkt_residuals(family):
    """Leg K's settings (adaptive rho, the K1 tier: the JAX package's
    kernel in interpret mode, the port's plain version).  The Rosenbrock's
    path is steered by rounding there (its outer counts part), so the
    statuses must be equal, every SOLVED problem of each package must meet
    the float64 KKT residuals to 1e-6, and x must agree to 1e-8 where both
    solved."""
    from chip_smoke import multi_outer_settings

    jgen, make, res_port, res_jax, _ = FAMILIES[family]
    s = multi_outer_settings(family)
    jp, jx0 = jgen(jax.random.PRNGKey(3), B, N, jnp.float64)
    pp = make(*(torch.tensor(np.asarray(getattr(jp, k))) for k in ("l", "u", "params")))
    jr = jax_sqp_solve_batch(jp, jx0, None, _jax_settings(s), impl="fused")
    pr = sqp_solve_batch(pp, torch.tensor(np.asarray(jx0)), None, s, impl="fused")
    status = pr.info.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(jr.info.status))
    solved = status == 0
    assert solved.mean() >= 0.75
    for pv, dr in (res_port(pp, pr.x, pr.lam), res_jax(jp, jr.x, jr.lam)):
        assert (pv[solved] <= 1e-6).all() and (dr[solved] <= 1e-6).all(), (pv, dr)
    np.testing.assert_allclose(pr.x.numpy()[solved], np.asarray(jr.x)[solved], atol=1e-8, rtol=0)
