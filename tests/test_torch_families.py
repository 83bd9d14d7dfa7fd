"""The OSQP-paper families (``models/families.py``) against the JAX package.

* The host generators draw from ``np.random.default_rng(seed)`` in the
  JAX package's order: the same problems draw for draw, with the same
  oracles (the equality class's closed-form x*, the meta dicts).
* The device twins, run here on the CPU from a seeded
  ``torch.Generator``, give symmetric PSD P (SPD for the random class),
  feasible bounds and the same draws again for the same seed; they do not
  reproduce ``jax.random``'s draws (ROADMAP Queue 3).
* Each family solves at the families leg's settings (``bench.py:1061-1065``:
  scaling 10, 300 iterations, fixed schedule, polish) on the vmap tier as
  the JAX package does, B = 4, float64 (on the plain K3:
  ``tests/test_torch_families_kernel.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models import families as jax_families
from sqp_solver_tpu.models import mpc as jax_mpc
from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models import families
from sqp_solver_tpu_torch.models import mpc as port_mpc
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus

LEAVES = ("P", "q", "A", "l", "u")
HOST = ("equality_qp_batch", "lasso_qp_batch", "huber_qp_batch", "svm_qp_batch",
        "portfolio_qp_batch")
DEVICE = ("random_qp_batch_device", "lasso_qp_batch_device", "huber_qp_batch_device",
          "svm_qp_batch_device", "portfolio_qp_batch_device")
FAMILY = dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=300, check_termination=25,
              adaptive_rho=True, adaptive_rho_interval=50, polish=True, scaling=10,
              schedule="fixed")
# small members of the leg's five classes, B = 4 (the random class is
# models/mpc.py's generator, whose device twin lives here)
SOLVE = {
    "random_qp_batch": dict(n=6, m=8),
    "lasso_qp_batch": dict(n_features=2, n_samples=4),
    "huber_qp_batch": dict(n_features=2, n_samples=4),
    "svm_qp_batch": dict(n_features=2, n_samples=4),
    "portfolio_qp_batch": dict(n_assets=4, n_factors=2),
}


def _pair(name):
    """The class's generators in both packages (the random class's are
    models/mpc.py's and give no meta)."""
    if name == "random_qp_batch":
        return jax_mpc.random_qp_batch, port_mpc.random_qp_batch
    return getattr(jax_families, name), getattr(families, name)


@pytest.mark.parametrize("name", HOST)
def test_host_generator_equals_jax_draw_for_draw(name):
    jq, jmeta = getattr(jax_families, name)(5, seed=3, dtype=jnp.float64)
    pq, pmeta = getattr(families, name)(5, seed=3, dtype=torch.float64, device="cpu")
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(pq, k).numpy(), np.asarray(getattr(jq, k)),
                                      err_msg=k)
    if isinstance(jmeta, dict):
        assert jmeta.keys() == pmeta.keys()
        for k, v in jmeta.items():
            np.testing.assert_array_equal(np.asarray(pmeta[k]), np.asarray(v), err_msg=k)
    else:  # the equality class's closed-form optimum
        np.testing.assert_array_equal(pmeta, jmeta)


@pytest.mark.parametrize("name", DEVICE)
def test_device_twin_gives_psd_p_and_feasible_bounds(name):
    fn = getattr(families, name)
    gen = torch.Generator(device="cpu").manual_seed(11)
    qp = fn(gen, 6, dtype=torch.float64)
    again = fn(11, 6, dtype=torch.float64, device="cpu")  # an integer seeds a generator
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(qp, k).numpy(), getattr(again, k).numpy())
    other = fn(12, 6, dtype=torch.float64, device="cpu")
    assert not torch.equal(qp.P, other.P) or not torch.equal(qp.A, other.A)
    P = qp.P.numpy()
    np.testing.assert_array_equal(P, P.transpose(0, 2, 1))
    eig = np.linalg.eigvalsh(P)
    assert eig.min() >= -1e-12
    if name == "random_qp_batch_device":
        assert eig.min() >= 0.1 - 1e-12  # M M' + 0.1 I
    assert (qp.l <= qp.u).all()
    # feasible: the vmap tier certifies an optimum of every problem
    res = qp_solve_batch(qp, QPSettings(**dict(FAMILY, max_iter=2000, eps_abs=1e-6,
                                               eps_rel=1e-6)))
    assert (res.info.status == QPStatus.SOLVED).all(), res.info.status
    Ax = torch.matmul(qp.A, res.x.unsqueeze(-1)).squeeze(-1)
    assert (Ax >= qp.l - 1e-4).all() and (Ax <= qp.u + 1e-4).all()


def _solve_both(name, impl):
    """One family through ``qp_solve_batch(impl=...)`` in both packages."""
    jgen, pgen = _pair(name)
    jq = jgen(4, seed=1, dtype=jnp.float64, **SOLVE[name])
    pq = pgen(4, seed=1, dtype=torch.float64, device="cpu", **SOLVE[name])
    if name != "random_qp_batch":
        jq, pq = jq[0], pq[0]
    jr = jax_qp_solve_batch(jq, JaxQPSettings(**FAMILY), impl=impl)
    port = interop.qp_result_to_numpy(qp_solve_batch(pq, QPSettings(**FAMILY), impl=impl))
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(port[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(port[k], np.asarray(getattr(jr, k)), atol=1e-9, rtol=0,
                                   err_msg=k)
    assert (port["status"] == QPStatus.SOLVED).sum() >= 3


@pytest.mark.parametrize("name", list(SOLVE))
def test_family_solves_on_the_vmap_tier_as_jax_does(name):
    _solve_both(name, "vmap")
