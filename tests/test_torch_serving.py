"""The port's QP serving path and sustained serving against the JAX package.

* the QP families (``models/mpc.py``): identical data for one seed;
* ``qp_solve_sequence`` on the double-integrator MPC fleet, port against
  JAX (float64, K = 3), plus the JAX semantics tests' properties in the
  port (``tests/test_sequence.py``): the sequence equals the hand-threaded
  loop, resume by state equals one long horizon, warm steps are cheaper
  than cold;
* ``sqp_solve_sequence`` equals its hand loop and matches JAX at K = 2 on
  the sphere-cap family;
* generators and constructors default to the card: on a host without one
  they raise instead of returning CPU tensors.

On the CPU the JAX side runs its Pallas kernels in interpret mode and the
port its kernels' plain versions.  Tolerances as in test_torch_qp.py:
counts and statuses equal, iterates to atol 1e-9 in float64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch as jax_sphere_cap
from sqp_solver_tpu.models.mpc import mpc_qp_batch as jax_mpc_qp_batch
from sqp_solver_tpu.models.mpc import random_qp_batch as jax_random_qp_batch
from sqp_solver_tpu.qp import qp_solve_sequence as jax_qp_solve_sequence
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu.sqp import sqp_solve_sequence as jax_sqp_solve_sequence
from sqp_solver_tpu.sqp.types import SQPSettings as JaxSQPSettings
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.models import benchmark as port_bench
from sqp_solver_tpu_torch.models.mpc import (
    _mpc_operators,
    mpc_fleet,
    mpc_qp_batch,
    random_qp_batch,
)
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings, QPState, QPStatus, QuadraticProblem
from sqp_solver_tpu_torch.qp import qp_solve_sequence
from sqp_solver_tpu_torch.sqp import SQPSettings, sqp_solve_sequence

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
MPC = dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200, check_termination=25,
           adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed")


@pytest.mark.parametrize("family", ["random", "mpc"])
def test_qp_families_identical_for_one_seed(family):
    if family == "random":
        jq = jax_random_qp_batch(5, n=6, m=9, seed=3, dtype=jnp.float64)
        pq = random_qp_batch(5, n=6, m=9, seed=3, dtype=torch.float64, device="cpu")
    else:
        jq = jax_mpc_qp_batch(5, horizon=7, seed=3, dtype=jnp.float64)
        pq = mpc_qp_batch(5, horizon=7, seed=3, dtype=torch.float64, device="cpu")
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(pq, k).numpy(), np.asarray(getattr(jq, k)),
                                      err_msg=k)
    j32 = jax_random_qp_batch(3, n=4, m=5, seed=1) if family == "random" else \
        jax_mpc_qp_batch(3, horizon=4, seed=1)
    p32 = random_qp_batch(3, n=4, m=5, seed=1, device="cpu") if family == "random" else \
        mpc_qp_batch(3, horizon=4, seed=1, device="cpu")
    assert p32.P.dtype == torch.float32
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(p32, k).numpy(), np.asarray(getattr(j32, k)))


def test_mpc_fleet_builds_the_batch_family():
    """The fleet's per-step QP at the batch's seeded plant states is the
    batch family's QP: one builder for both."""
    qp = mpc_qp_batch(5, horizon=7, seed=4, dtype=torch.float64, device="cpu")
    x0 = np.random.default_rng(4).uniform(-1.0, 1.0, size=(5, 2))
    make_qp, _ = mpc_fleet(5, horizon=7, dtype=torch.float64, device="cpu")
    fq = make_qp(torch.as_tensor(x0))
    for k in LEAVES:
        np.testing.assert_allclose(getattr(fq, k).numpy(), getattr(qp, k).numpy(),
                                   atol=1e-14, rtol=0, err_msg=k)


def _generator_calls():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3, 2))
    return {
        "sphere_cap_nlp_batch": lambda: port_bench.sphere_cap_nlp_batch(2, 3),
        "mpc_qp_batch": lambda: mpc_qp_batch(2, horizon=3),
        "random_qp_batch": lambda: random_qp_batch(2, 3, 4),
        "QPState.zeros": lambda: QPState.zeros(2, 3, 4),
        "from_kernel_layout": lambda: interop.from_kernel_layout(v),
        "qp_state_from_numpy": lambda: interop.qp_state_from_numpy(v, v, v),
        "qp_from_arrays": lambda: interop.qp_from_arrays(v, v, v, v, v),
    }


@pytest.mark.parametrize("name", sorted(_generator_calls()))
def test_generators_default_to_the_card(name):
    """Without ``device`` the tensors go to the card; a host without one
    raises rather than handing back CPU tensors."""
    call = _generator_calls()[name]
    if torch.cuda.is_available():
        out = call()
        first = out[0] if isinstance(out, tuple) else out
        t = first if isinstance(first, torch.Tensor) else next(
            v for v in vars(first).values() if isinstance(v, torch.Tensor))
        assert t.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# qp_solve_sequence
# ---------------------------------------------------------------------------


def _fleet(horizon=8, batch=4, dt=0.1):
    """The sustained-MPC fleet of bench.py:854-901 at a small size, for
    the JAX side: the shared matrices from the port's builder, the step's
    q, l, u rebuilt by hand from the plant state (B, 2), the carry."""
    P, A, Sp_x, Sp_u, Sv_x = _mpc_operators(horizon, dt, 0.1)
    return dict(P=P, A=A, Spx_x=Sp_x.T, Spx_u=Sp_u, Svx_x=Sv_x.T,
                Ad=np.array([[1.0, dt], [0.0, 1.0]]), Bd=np.array([0.5 * dt * dt, dt]),
                H=horizon, B=batch)


def _port_fleet(batch=4, horizon=8):
    make_qp, step = mpc_fleet(batch, horizon=horizon, dtype=torch.float64, device="cpu")

    def advance(st, r):
        nxt = step(st, r.x[:, 0])
        return nxt, (r.x, r.info.iter, r.info.status, (nxt[:, 0] ** 2).mean().sqrt())

    return make_qp, advance


def _jax_fleet(f):
    c = {k: jnp.asarray(v) for k, v in f.items() if isinstance(v, np.ndarray)}
    H, B = f["H"], f["B"]

    def make_qp(st):
        voff = st @ c["Svx_x"]
        return JaxQP(
            P=jnp.broadcast_to(c["P"], (B, H, H)), q=(st @ c["Spx_x"]) @ c["Spx_u"],
            A=jnp.broadcast_to(c["A"], (B, 2 * H, H)),
            l=jnp.concatenate([jnp.full((B, H), -2.0), -1.5 - voff], axis=1),
            u=jnp.concatenate([jnp.full((B, H), 2.0), 1.5 - voff], axis=1),
        )

    def advance(st, r):
        nxt = st @ c["Ad"].T + r.x[:, 0][:, None] * c["Bd"]
        return nxt, (r.x, r.info.iter, r.info.status, jnp.sqrt(jnp.mean(nxt[:, 0] ** 2)))

    return make_qp, advance


def _plant0(batch=4, seed=21):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(batch, 2))


def test_qp_solve_sequence_matches_jax():
    """K = 3 steps of the fleet, warm-started, both packages."""
    f = _fleet()
    x0 = _plant0()
    pm, pa = _port_fleet()
    jm, ja = _jax_fleet(f)
    (px, pit, pst, prms), pcarry, pstate = qp_solve_sequence(
        pm, pa, torch.as_tensor(x0), 3, QPSettings(**MPC), impl="kernel")
    (jx, jit, jst, jrms), jcarry, jstate = jax_qp_solve_sequence(
        jm, ja, jnp.asarray(x0), 3, JaxQPSettings(**MPC), impl="kernel")
    assert px.shape == (3, 4, 8) and prms.shape == (3,)
    np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst))
    assert (pst.numpy() == QPStatus.SOLVED).all()
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pcarry.numpy(), np.asarray(jcarry), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pstate.y.numpy(), np.asarray(jstate.y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(prms.numpy(), np.asarray(jrms), atol=ATOL, rtol=0)


# the JAX semantics tests' hard operator (tests/test_sequence.py:22-60)
B, N = 4, 3
M = N + 1
SEQ = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=400, check_termination=25,
                 adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed")


def _make_qp():
    rng = np.random.RandomState(7)
    Q1, _ = np.linalg.qr(rng.randn(N, N))
    P1 = torch.as_tensor(Q1 @ np.diag([1e-3, 0.3, 30.0]) @ Q1.T)
    A1 = torch.as_tensor(np.concatenate([np.eye(N), np.ones((1, N))], axis=0))
    l1 = torch.as_tensor(np.concatenate([-np.ones(N), [-2.0]]))
    u1 = torch.as_tensor(np.concatenate([np.ones(N), [2.0]]))

    def make_qp(carry):
        return QuadraticProblem(
            P=P1.expand(B, N, N).contiguous(), q=carry,
            A=A1.expand(B, M, N).contiguous(), l=l1.expand(B, M).contiguous(),
            u=u1.expand(B, M).contiguous(),
        )

    return make_qp


def _advance(carry, res):
    return carry + 0.01 * res.x, (res.x, res.info.iter, res.info.status)


def _carry0():
    return torch.as_tensor(np.random.default_rng(11).uniform(-1.0, 1.0, size=(B, N)))


def test_qp_sequence_equals_hand_threaded_loop():
    make_qp = _make_qp()
    (xs, iters, sts), carry_f, state_f = qp_solve_sequence(
        make_qp, _advance, _carry0(), 4, SEQ, impl="kernel")
    carry, state = _carry0(), None
    for k in range(4):
        res = qp_solve_batch(make_qp(carry), SEQ, state=state, impl="kernel")
        carry, (xk, itk, stk) = _advance(carry, res)
        state = res.state
        assert torch.equal(xs[k], xk) and torch.equal(iters[k], itk)
        assert torch.equal(sts[k], stk)
    assert torch.equal(carry_f, carry) and torch.equal(state_f.y, state.y)
    assert (sts == QPStatus.SOLVED).all()


def test_qp_sequence_resume_by_state_equals_one_long_horizon():
    make_qp = _make_qp()
    full, _, _ = qp_solve_sequence(make_qp, _advance, _carry0(), 5, SEQ, impl="kernel")
    head, carry_m, state_m = qp_solve_sequence(make_qp, _advance, _carry0(), 2, SEQ,
                                               impl="kernel")
    tail, _, _ = qp_solve_sequence(make_qp, _advance, carry_m, 3, SEQ, impl="kernel",
                                   state0=state_m)
    np.testing.assert_allclose(full[0][:2].numpy(), head[0].numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(full[0][2:].numpy(), tail[0].numpy(), atol=1e-12, rtol=0)


def test_qp_sequence_warm_steps_cheaper_than_cold():
    make_qp = _make_qp()
    (_, iters, _), _, _ = qp_solve_sequence(make_qp, _advance, _carry0(), 4, SEQ,
                                            impl="kernel")
    warm_total = int(iters[1:].sum())
    carry, state, cold_total = _carry0(), None, 0
    for k in range(4):
        if k > 0:
            cold_total += int(qp_solve_batch(make_qp(carry), SEQ, impl="kernel").info.iter.sum())
        res_w = qp_solve_batch(make_qp(carry), SEQ, state=state, impl="kernel")
        carry, _ = _advance(carry, res_w)
        state = res_w.state
    assert warm_total < cold_total, (warm_total, cold_total)


def test_stack_outputs_keeps_the_structure():
    from sqp_solver_tpu_torch.qp.sequence import stack_outputs

    outs = [dict(a=torch.full((2,), float(k)), b=(k, [torch.tensor(k)])) for k in range(3)]
    st = stack_outputs(outs)
    assert st["a"].shape == (3, 2) and torch.equal(st["b"][0], torch.tensor([0, 1, 2]))
    assert isinstance(st["b"][1], list) and torch.equal(st["b"][1][0], torch.tensor([0, 1, 2]))


# ---------------------------------------------------------------------------
# sqp_solve_sequence
# ---------------------------------------------------------------------------

SQP = SQPSettings(
    max_iter=3, eps_prim=2e-3, eps_dual=2e-3, termination="kkt", schedule="fixed",
    qp_impl="kernel", polish=True, polish_passes=2, line_search_max_iter=5,
    qp=QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50, check_termination=10,
                  warm_start=True, adaptive_rho=True, adaptive_rho_interval=50,
                  schedule="fixed"),
)


def _port_nlp(n):
    def make_nlp(r):
        Bn = r.shape[0]
        l = torch.zeros((Bn, n + 1), dtype=r.dtype)
        u = torch.cat([(r ** 2)[:, None], torch.ones((Bn, n), dtype=r.dtype)], dim=1)
        return port_bench.sphere_cap_problem(l, u, r), torch.full((Bn, n), 0.25, dtype=r.dtype)

    def advance(r, res):
        return 0.98 * r, (res.x, res.info.iter, res.info.status)

    return make_nlp, advance


def test_sqp_sequence_equals_hand_threaded_loop():
    make_nlp, advance = _port_nlp(5)
    r0 = torch.as_tensor(np.random.default_rng(3).uniform(0.6, 0.85, 4) * np.sqrt(5))
    warm_settings = dataclasses.replace(SQP, max_iter=1)
    (xs, iters, sts), r_f, (x_f, lam_f) = sqp_solve_sequence(
        make_nlp, advance, r0, 3, warm_settings, impl="fused")
    r = r0
    prob, x0 = make_nlp(r)
    warm = (x0, torch.zeros((4, 6), dtype=r.dtype))
    for k in range(3):
        prob, _ = make_nlp(r)
        res = sqp_solve_batch(prob, warm[0], warm[1], warm_settings, impl="fused")
        r, (xk, itk, stk) = advance(r, res)
        warm = (res.x, res.lam)
        assert torch.equal(xs[k], xk) and torch.equal(iters[k], itk) and torch.equal(sts[k], stk)
    assert torch.equal(r_f, r) and torch.equal(x_f, warm[0]) and torch.equal(lam_f, warm[1])


def test_sqp_sequence_matches_jax():
    """One cold headline solve hands its (x, lam) to K = 2 warm steps, as
    the sustained-NLP leg does (bench.py:992-1000), in both packages."""
    n, batch = 6, 4
    jp, jx0 = jax_sphere_cap(batch, n, seed=5, dtype=jnp.float64)
    r0 = np.array(jp.params)
    to_jax = dict((f.name, getattr(SQP, f.name)) for f in dataclasses.fields(SQP)
                  if f.name != "qp")
    jset = JaxSQPSettings(**to_jax, qp=JaxQPSettings(**dataclasses.asdict(SQP.qp)))
    jwarm = dataclasses.replace(jset, max_iter=1)

    def jmake(r):
        l = jnp.zeros((batch, n + 1))
        u = jnp.concatenate([(r ** 2)[:, None], jnp.ones((batch, n))], axis=1)
        return dataclasses.replace(jp, l=l, u=u, params=r), jnp.full((batch, n), 0.25)

    def jadv(r, res):
        return 0.98 * r, (res.x, res.info.status)

    from sqp_solver_tpu.parallel.batch import sqp_solve_batch as jax_sqp_solve_batch

    jres0 = jax_sqp_solve_batch(jmake(jnp.asarray(r0))[0], jx0, None, jset, impl="fused")
    (jxs, jsts), jr_f, (jx_f, jlam_f) = jax_sqp_solve_sequence(
        jmake, jadv, 0.98 * jnp.asarray(r0), 2, jwarm, impl="fused",
        warm0=(jres0.x, jres0.lam))

    make_nlp, _ = _port_nlp(n)
    pr0 = torch.as_tensor(r0)
    pres0 = sqp_solve_batch(make_nlp(pr0)[0], torch.as_tensor(np.array(jx0)), None, SQP,
                            impl="fused")
    (pxs, psts), pr_f, (px_f, plam_f) = sqp_solve_sequence(
        make_nlp, lambda r, res: (0.98 * r, (res.x, res.info.status)), 0.98 * pr0, 2,
        dataclasses.replace(SQP, max_iter=1), impl="fused", warm0=(pres0.x, pres0.lam))
    np.testing.assert_array_equal(psts.numpy(), np.asarray(jsts))
    assert (psts.numpy() == 0).all()
    np.testing.assert_allclose(pxs.numpy(), np.asarray(jxs), atol=1e-8, rtol=0)
    np.testing.assert_allclose(plam_f.numpy(), np.asarray(jlam_f), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr_f.numpy(), np.asarray(jr_f), rtol=1e-15)
