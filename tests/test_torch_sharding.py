"""The batch split over devices (``parallel/sharding.py``) on two CPU
devices, as the JAX package's ``tests/test_sharding.py`` runs its mesh:
each sharded solve equals the unsharded one (statuses, counts, x), on the
vmap, kernel and fused tiers, with batched and shared bounds and the
record-trace buffers joined on their batch axis.

The same float64 inputs also go through the JAX package's sharded
functions over two of the eight virtual CPU devices that
``tests/conftest.py`` gives JAX (``np.asarray`` gathers a sharded
result): statuses and counts equal, x and y to atol 1e-9 on the
per-problem QP tier (the bar of ``test_torch_reference.py``), x, lambda
and the record-trace buffers to 1e-8 on the fused SQP tier (the bar of
``test_torch_slice.py``).  The per-problem SQP tier on the simple NLP
from the JAX test's random starts at the default settings is a case
where rounding steers the path (ROADMAP Queue 3): the counts are equal,
x is held to 1e-6 of JAX's and lambda to 1e-5 (measured 1.8e-7 and
1.8e-6), and both to the optimum as closely as JAX's own result."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch as jax_sphere_cap
from sqp_solver_tpu.models.mpc import random_qp_batch as jax_random_qp_batch
from sqp_solver_tpu.models.problems import simple_nlp as jax_simple_nlp
from sqp_solver_tpu.parallel import sharding as jax_sharding
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.sqp.types import SQPSettings as JaxSQPSettings

from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch, sphere_cap_solution
from sqp_solver_tpu_torch.models.mpc import random_qp_batch
from sqp_solver_tpu_torch.models.problems import simple_nlp
from sqp_solver_tpu_torch.parallel import (
    make_mesh,
    qp_solve_batch,
    shard_batch,
    sharded_qp_solve_batch,
    sharded_sqp_solve_batch,
    sqp_solve_batch,
)
from sqp_solver_tpu_torch.qp import QPSettings, QPStatus
from sqp_solver_tpu_torch.sqp import SQPSettings, SQPStatus

MESH = make_mesh(["cpu", "cpu"])
KERNEL_QP = QPSettings(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
                       adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed")


JAX_MESH = jax_sharding.make_mesh(jax.devices()[:2])


def _jax_qp_settings(s: QPSettings) -> JaxQPSettings:
    return JaxQPSettings(**dataclasses.asdict(s))


def _jax_sqp_settings(s: SQPSettings) -> JaxSQPSettings:
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.name != "qp"}
    return JaxSQPSettings(**fields, qp=_jax_qp_settings(s.qp))


def _like_jax(out, jr, keys, atol):
    for k in ("status", "iter"):
        np.testing.assert_array_equal(getattr(out.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in keys:
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=atol, rtol=0, err_msg=k)


def _same(out, ref, atol=1e-12):
    for k in ("status", "iter"):
        np.testing.assert_array_equal(getattr(out.info, k).numpy(), getattr(ref.info, k).numpy())
    np.testing.assert_allclose(out.x.numpy(), ref.x.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("impl,dtype", [("vmap", torch.float64), ("kernel", torch.float32),
                                        ("fused", torch.float64)])
def test_sharded_qp_matches_unsharded(impl, dtype):
    qp = random_qp_batch(32, 8, 12, dtype=dtype, device="cpu")
    settings = (QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=4000) if impl == "vmap"
                else KERNEL_QP)
    ref = qp_solve_batch(qp, settings, impl=impl)
    out = sharded_qp_solve_batch(qp, settings, MESH, impl=impl)
    _same(out, ref, atol=1e-12 if dtype == torch.float64 else 1e-6)
    assert out.x.shape == (32, 8) and out.x.device == qp.q.device
    assert (out.info.status == QPStatus.SOLVED).float().mean() > 0.9


def test_sharded_sqp_shared_bounds_matches_unsharded():
    prob = simple_nlp(device="cpu")  # bounds (m,) shared by the batch
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 1.5, (16, 2)))
    ref = sqp_solve_batch(prob, x0, None, SQPSettings())
    out = sharded_sqp_solve_batch(prob, x0, None, SQPSettings(), MESH)
    _same(out, ref)
    assert (out.info.status == SQPStatus.SOLVED).all()


def test_sharded_kernel_tier_and_record_trace():
    """The K1 tier (its plain version here) with batched bounds and params,
    and the record-trace buffers (max_iter, B, ...) joined on axis 1."""
    problem, x0 = sphere_cap_nlp_batch(32, 8, dtype=torch.float32, device="cpu")
    s = SQPSettings(max_iter=5, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
                    schedule="fixed", qp_impl="kernel", polish=True, record_trace=True,
                    qp=KERNEL_QP)
    ref = sqp_solve_batch(problem, x0, None, s, impl="fused")
    out = sharded_sqp_solve_batch(problem, x0, None, s, MESH, impl="fused")
    _same(out, ref, atol=1e-6)
    assert out.trace["x"].shape == (5, 32, 8)
    for k, v in out.trace.items():
        np.testing.assert_allclose(v.numpy(), ref.trace[k].numpy(), atol=1e-6, err_msg=k)
    ok = out.info.status.numpy() == SQPStatus.SOLVED
    assert ok.mean() > 0.9
    assert np.abs(out.x.numpy() - sphere_cap_solution(problem))[ok].max() < 1e-4


def test_sharded_qp_matches_jax_sharded():
    """random_qp_batch on the per-problem tier over two devices in both
    packages."""
    settings = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=4000)
    qp = random_qp_batch(32, 8, 12, dtype=torch.float64, device="cpu")
    jqp = jax_random_qp_batch(batch=32, n=8, m=12, dtype=jnp.float64)
    jr = jax_sharding.sharded_qp_solve_batch(jax_sharding.shard_batch(jqp, JAX_MESH),
                                             _jax_qp_settings(settings), JAX_MESH)
    out = sharded_qp_solve_batch(qp, settings, MESH)
    _like_jax(out, jr, ("x", "y"), 1e-9)
    assert (out.info.status == QPStatus.SOLVED).float().mean() > 0.9


def test_sharded_sqp_matches_jax_sharded():
    """simple_nlp: the port's shared bounds against the JAX package's
    bounds broadcast to the batch (its sharded call wants every leaf
    batched)."""
    B = 16
    x0 = np.random.default_rng(0).uniform(0.5, 1.5, (B, 2))
    jp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jax_simple_nlp())
    jr = jax_sharding.sharded_sqp_solve_batch(
        jax_sharding.shard_batch(jp, JAX_MESH), jax_sharding.shard_batch(jnp.asarray(x0), JAX_MESH),
        None, _jax_sqp_settings(SQPSettings()), JAX_MESH)
    out = sharded_sqp_solve_batch(simple_nlp(device="cpu"), torch.as_tensor(x0), None,
                                  SQPSettings(), MESH)
    _like_jax(out, jr, ("x",), 1e-6)
    np.testing.assert_allclose(out.lam.numpy(), np.asarray(jr.lam), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out.info.qp_solver_iter.numpy(),
                                  np.asarray(jr.info.qp_solver_iter))
    assert (out.info.status == SQPStatus.SOLVED).all()
    for got, want, star in ((out.x.numpy(), np.asarray(jr.x), [1.0, 1.0]),
                            (out.lam.numpy(), np.asarray(jr.lam), [0.5, 0.0, 0.0])):
        err, err_jax = (np.abs(v - np.asarray(star)).max(1) for v in (got, want))
        assert (err <= err_jax + 1e-5).all()


def test_sharded_kernel_tier_record_trace_matches_jax_sharded():
    """The sphere cap on the fused SQP tier with ``qp_impl="kernel"`` (the
    JAX package's Pallas kernels in interpret mode, the port's plain
    versions) and ``record_trace``: the JAX result's (max_iter, B, ...)
    buffers sharded on axis 1, the port's joined on axis 1."""
    B, N, T = 8, 4, 4
    s = SQPSettings(max_iter=T, termination="kkt", eps_prim=1e-3, eps_dual=1e-3,
                    schedule="fixed", qp_impl="kernel", polish=True, record_trace=True,
                    qp=dataclasses.replace(KERNEL_QP, max_iter=50, check_termination=10,
                                           warm_start=True))
    jp, jx0 = jax_sphere_cap(B, N, seed=1, dtype=jnp.float64)
    jr = jax_sharding.sharded_sqp_solve_batch(
        jax_sharding.shard_batch(jp, JAX_MESH), jax_sharding.shard_batch(jx0, JAX_MESH), None,
        _jax_sqp_settings(s), JAX_MESH, impl="fused")
    problem, x0 = sphere_cap_nlp_batch(B, N, seed=1, dtype=torch.float64, device="cpu")
    out = sharded_sqp_solve_batch(problem, x0, None, s, MESH, impl="fused")
    _like_jax(out, jr, ("x", "lam"), 1e-8)
    assert out.trace["x"].shape == (T, B, N) and set(out.trace) == set(jr.trace)
    for k, v in out.trace.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jr.trace[k]), atol=1e-8, err_msg=k)
    assert (out.info.status.numpy() == SQPStatus.SOLVED).mean() > 0.9


def test_mesh_and_shard_batch():
    t = torch.arange(10.0).reshape(5, 2)
    parts = shard_batch(t, MESH)
    assert [p.shape[0] for p in parts] == [3, 2]
    assert torch.equal(torch.cat(parts), t)
    with pytest.raises(ValueError, match="batch"):
        shard_batch(t[:1], MESH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
