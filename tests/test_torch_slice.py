"""The port's main path against the JAX package, end to end.

``sqp_solve_batch(impl="fused")`` with ``qp_impl="kernel"`` runs in both
packages on the same sphere-cap batch (same numpy seed).  On the CPU the
JAX side runs its Pallas kernels in interpret mode and the port its plain
kernel versions.  In float64 statuses and iteration counts must agree
exactly and (x, lambda) to 1e-8; in float32 the port must meet the
closed form as well as JAX does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch as jax_sphere_cap
from sqp_solver_tpu.models.benchmark import sphere_cap_solution as jax_solution
from sqp_solver_tpu.parallel.batch import sqp_solve_batch as jax_solve_batch
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.sqp.types import NonlinearProblem as JaxNonlinearProblem
from sqp_solver_tpu.sqp.types import SQPSettings as JaxSQPSettings
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models import benchmark as port_models
from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPSettings, SQPStatus

HEADLINE = SQPSettings(
    max_iter=3, eps_prim=2e-3, eps_dual=2e-3, termination="kkt", schedule="fixed",
    qp_impl="kernel", polish=True, polish_passes=2, line_search_max_iter=5,
    qp=QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                  check_termination=10, warm_start=True, adaptive_rho=True,
                  adaptive_rho_interval=50, schedule="fixed"),
)


def to_jax_settings(s: SQPSettings) -> JaxSQPSettings:
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.name != "qp"}
    return JaxSQPSettings(**fields, qp=JaxQPSettings(**dataclasses.asdict(s.qp)))


def test_settings_and_statuses_move_across_one_to_one():
    def defaults(cls):
        return {f.name: dataclasses.asdict(f.default) if dataclasses.is_dataclass(f.default)
                else f.default for f in dataclasses.fields(cls)}

    assert defaults(QPSettings) == defaults(JaxQPSettings)
    assert defaults(SQPSettings) == defaults(JaxSQPSettings)
    from sqp_solver_tpu.qp.types import QPStatus as JaxQPStatus
    from sqp_solver_tpu.sqp.types import SQPStatus as JaxSQPStatus

    assert {s.name: int(s) for s in QPStatus} == {s.name: int(s) for s in JaxQPStatus}
    assert {s.name: int(s) for s in SQPStatus} == {s.name: int(s) for s in JaxSQPStatus}
    with pytest.raises(ValueError, match="tau"):
        SQPSettings(tau=1.5).validate()


def test_constraint_classification_matches_jax():
    from sqp_solver_tpu.qp.classify import constr_type_init as jax_classify
    from sqp_solver_tpu_torch.qp.classify import constr_type_init

    l = np.array([-1e20, -1.0, 0.5, -1e20, 2.0, 0.0])
    u = np.array([1e20, 1.0, 0.5 + 5e-5, 3.0, 2.0, 1e20])
    np.testing.assert_array_equal(
        constr_type_init(torch.as_tensor(l), torch.as_tensor(u)).numpy(),
        np.asarray(jax_classify(jnp.asarray(l), jnp.asarray(u))),
    )


def test_solver_entry_pins_float32_matmul_precision():
    """TF32 is off for the whole solve, user callables included, and the
    caller's settings come back afterwards."""
    seen = []
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        pp, px0 = port_models.sphere_cap_nlp_batch(2, 3, seed=0, dtype=torch.float64,
                                               device="cpu")
        settings = dataclasses.replace(HEADLINE, max_iter=1, iteration_callback=lambda *a: seen.append(
            (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)))
        sqp_solve_batch(pp, px0, None, settings, impl="fused")
        assert seen and all(v == ("highest", False) for v in seen)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_sphere_cap_data_identical_for_one_seed():
    jp, jx0 = jax_sphere_cap(16, 9, seed=7, dtype=jnp.float64)
    pp, px0 = port_models.sphere_cap_nlp_batch(16, 9, seed=7, dtype=torch.float64,
                                               device="cpu")
    for a, b in ((jp.l, pp.l), (jp.u, pp.u), (jp.params, pp.params), (jx0, px0)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(jax_solution(jp), port_models.sphere_cap_solution(pp))
    # the hooks agree with the JAX layout-native ones
    x = np.asarray(jx0) + 0.1
    lam = np.linspace(0.5, 1.5, 16 * 10).reshape(16, 10)
    jc, jJt = jp.constraint_linearized_t(jnp.asarray(x), jp.params)
    pc, pJ = pp.constraint_linearized(torch.as_tensor(x), pp.params)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-15)
    np.testing.assert_array_equal(interop.to_kernel_layout(pJ), np.asarray(jJt))
    jH = jp.lagrangian_hessian_t(jnp.asarray(x), jnp.asarray(lam), jp.params)
    pH = pp.lagrangian_hessian(torch.as_tensor(x), torch.as_tensor(lam), pp.params)
    np.testing.assert_array_equal(interop.to_kernel_layout(pH), np.asarray(jH))


def test_interop_round_trips():
    rng = np.random.default_rng(0)
    Bt = rng.standard_normal((5, 5, 3))
    B = interop.hessian_from_numpy(Bt, device="cpu")
    assert B.shape == (3, 5, 5)
    np.testing.assert_array_equal(B[1].numpy(), Bt[:, :, 1])
    np.testing.assert_array_equal(interop.to_kernel_layout(B), Bt)
    v = rng.standard_normal((4, 3))
    np.testing.assert_array_equal(
        interop.to_kernel_layout(interop.from_kernel_layout(v, device="cpu")), v
    )
    x, z, y = rng.standard_normal((3, 4)), rng.standard_normal((3, 6)), rng.standard_normal((3, 6))
    st = interop.qp_state_from_numpy(x, z, y, dtype=torch.float32, device="cpu")
    assert st.x.dtype == torch.float32 and st.z.shape == (3, 6)
    np.testing.assert_allclose(st.y.numpy(), y, rtol=1e-7)
    jp, _ = jax_sphere_cap(3, 4, seed=1, dtype=jnp.float64)
    pp = interop.sphere_cap_from_arrays(np.asarray(jp.l), np.asarray(jp.u),
                                        np.asarray(jp.params), device="cpu")
    xs = rng.uniform(size=(3, 4))
    np.testing.assert_allclose(
        pp.constraint(torch.as_tensor(xs), pp.params).numpy(),
        np.stack([np.asarray(jp.constraint(jnp.asarray(r), None)) for r in xs]),
        rtol=1e-15,
    )


def _solve_both(batch, n, seed, settings, dtype_np, hooks=True):
    jdt = jnp.float64 if dtype_np == np.float64 else jnp.float32
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    jp, jx0 = jax_sphere_cap(batch, n, seed=seed, dtype=jdt)
    pp, px0 = port_models.sphere_cap_nlp_batch(batch, n, seed=seed, dtype=tdt, device="cpu")
    if not hooks:  # derivatives from autodiff in both packages
        jp = JaxNonlinearProblem(l=jp.l, u=jp.u, params=jp.params,
                                 objective=jp.objective, constraint=jp.constraint)
        pp = NonlinearProblem(l=pp.l, u=pp.u, params=pp.params,
                              objective=pp.objective, constraint=pp.constraint)
    jr = jax_solve_batch(jp, jx0, None, to_jax_settings(settings), impl="fused")
    pr = sqp_solve_batch(pp, px0, None, settings, impl="fused")
    return jp, jr, pp, pr


def test_main_path_matches_jax_float64():
    """Headline settings, B = 8, n = 8."""
    _, jr, pp, pr = _solve_both(8, 8, 1, HEADLINE, np.float64)
    for k in ("status", "iter", "qp_solver_iter"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    assert (pr.info.status.numpy() == SQPStatus.SOLVED).all()
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.info.primal_step_norm.numpy(),
                               np.asarray(jr.info.primal_step_norm), atol=1e-8)


def test_soc_step_norm_autodiff_and_trace_match_jax_float64():
    """SOC with factor reuse, step-norm termination with early exit, no
    derivative hooks (torch.func against jax autodiff), the recorded
    trace and the live iteration callback."""
    calls = []
    settings = dataclasses.replace(
        HEADLINE, max_iter=4, termination="step_norm", schedule="early_exit",
        second_order_correction=True, record_trace=True, polish_passes=1,
    )
    _, jr, _, pr = _solve_both(4, 6, 2, dataclasses.replace(
        settings, iteration_callback=None), np.float64, hooks=False)
    for k in ("status", "iter", "qp_solver_iter"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=1e-8, rtol=0)
    for k in ("x", "alpha", "primal_step_norm"):
        np.testing.assert_allclose(pr.trace[k].numpy(), np.asarray(jr.trace[k]),
                                   atol=1e-8, err_msg=k)
    pp, px0 = port_models.sphere_cap_nlp_batch(4, 6, seed=2, dtype=torch.float64,
                                               device="cpu")
    sqp_solve_batch(pp, px0, None, dataclasses.replace(
        settings, iteration_callback=lambda x, lam, k: calls.append(k)), impl="fused")
    assert calls[0] == 0 and calls == list(range(len(calls)))


def test_main_path_float32_meets_the_closed_form():
    """f32, B = 64, n = 16: the port's err_p99 against the closed form is no
    worse than max(2x JAX's on the same input, 1e-6)."""
    jp, jr, pp, pr = _solve_both(64, 16, 3, HEADLINE, np.float32)
    sol = port_models.sphere_cap_solution(pp)
    err_port = np.percentile(np.abs(pr.x.numpy().astype(np.float64) - sol), 99)
    err_jax = np.percentile(np.abs(np.asarray(jr.x, np.float64) - sol), 99)
    assert err_port <= max(2.0 * err_jax, 1e-6), (err_port, err_jax)
    assert np.mean(pr.info.status.numpy() == SQPStatus.SOLVED) >= 0.99


@pytest.mark.parametrize("kind", ["qp_impl"])
def test_outside_the_slice_raises_not_implemented(kind):
    """The structured tier (``qp_impl="kernel_btd"``) raises the JAX
    package's ValueErrors for its scaling and block limits.  Anderson on
    the kernel tiers, scaling and ``impl="vmap"`` no longer raise:
    tests/test_torch_anderson_kernel.py, tests/test_torch_anderson_btd.py,
    tests/test_torch_scaling.py and tests/test_torch_reference_sqp.py."""
    pp, px0 = port_models.sphere_cap_nlp_batch(2, 4, seed=0, dtype=torch.float64,
                                               device="cpu")
    impl = "fused"
    # the structured tier is ported: its own limits raise ValueError as in
    # the JAX package (tests/test_sqp_btd.py::test_validation)
    btd = dataclasses.replace(HEADLINE, qp_impl="kernel_btd",
                              qp=dataclasses.replace(HEADLINE.qp, block_size=2))
    with pytest.raises(ValueError, match="scaling"):
        sqp_solve_batch(pp, px0, None, dataclasses.replace(
            btd, qp=dataclasses.replace(btd.qp, scaling=4)), impl=impl)
    with pytest.raises(ValueError, match="multiple"):  # n = 4, internal block 8
        sqp_solve_batch(pp, px0, None, btd, impl=impl)
    with pytest.raises(ValueError, match="block_size"):
        dataclasses.replace(btd, qp=dataclasses.replace(btd.qp, block_size=0)).validate()
