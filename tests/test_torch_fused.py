"""The port's fused ADMM tier against the JAX package.

The same numpy inputs, float64, go through the JAX functions and their
twins in the port:

* the ADMM chunk (K5): the port's plain version against the JAX Pallas
  kernel in interpret mode and against its XLA fallback;
* the ``schur_cholesky`` factor (W, Minv, and NaN on a non-SPD problem),
  the infeasibility certificates and the Anderson step;
* ``qp_solve_batch(impl="fused")`` against JAX ``qp_solve_fused`` on its
  XLA backend (the chunk the JAX package runs off the TPU): both
  schedules, warm start, a batch of 5 (which JAX pads to its tile and the
  port does not), infeasible problems, ``check_comp_slack``, Anderson and
  polish;
* ``sqp_solve_batch(impl="fused")`` with ``qp_impl="fused"`` on the
  sphere cap and on the portfolio objective of ``examples/portfolio_nlp.py``
  with no derivative hooks (``torch.func`` against JAX autodiff);
* the batch-first ``polish_nlp`` against both JAX epilogues, up to n = 130;
* ``qp_solve_sequence(impl="fused")`` and ``sqp_solve_sequence`` over the
  fused SQP tier.

Tolerances: iterates to atol 1e-9 (float64 summed in another order over
up to 200 ADMM iterations); on infeasible problems, whose iterates run off
along the certificate, atol 1e-9 plus rtol 1e-9; statuses, iteration and
rho-update counts exactly; the adaptive rho estimate, a ratio of residual
norms near the float64 floor, to rtol 1e-6 (ROADMAP Queue 3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops import admm_kernel as jax_ak
from sqp_solver_tpu.ops.linear_solver import _schur_factor as jax_schur_factor
from sqp_solver_tpu.parallel.batch import sqp_solve_batch as jax_sqp_solve_batch
from sqp_solver_tpu.qp import qp_solve_sequence as jax_qp_solve_sequence
from sqp_solver_tpu.qp.admm_batched import qp_solve_fused as jax_qp_solve_fused
from sqp_solver_tpu.qp.anderson import anderson_extrapolate as jax_anderson
from sqp_solver_tpu.qp.infeasibility import infeasibility_certificates as jax_certificates
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu.sqp import common as jax_common
from sqp_solver_tpu.sqp import sqp_solve_sequence as jax_sqp_solve_sequence
from sqp_solver_tpu.sqp.types import NonlinearProblem as JaxNonlinearProblem
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import admm_kernel as ak
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.ops.linear_solver import _schur_factor
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings, QPStatus, qp_solve_sequence
from sqp_solver_tpu_torch.qp.anderson import anderson_extrapolate, anderson_init
from sqp_solver_tpu_torch.qp.infeasibility import infeasibility_certificates
from sqp_solver_tpu_torch.sqp import NonlinearProblem, SQPSettings, SQPStatus, sqp_solve_sequence
from sqp_solver_tpu_torch.sqp import common
from sqp_solver_tpu_torch.testing import admm_chunk_inputs, certificate_qp_inputs, qp_inputs
from test_torch_serving import _fleet, _jax_fleet, _plant0, _port_fleet, _port_nlp
from test_torch_slice import HEADLINE, _solve_both, to_jax_settings

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
CHUNK_ARGS = ("W", "P", "A", "qv", "scale1", "rhoip", "rhop", "lp", "up", "s", "yp")
# the one-shot QP leg's settings (bench.py:814-818) on the fused tier
BENCH = dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200, check_termination=25,
             adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed")
FUSED = dataclasses.replace(HEADLINE, qp_impl="fused")


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# K5 and the pieces around it
# ---------------------------------------------------------------------------


def test_admm_chunk_reference_matches_jax_kernel_and_fallback():
    """Five iterations and the chunk-end stats, with an equality row and a
    loose row: the plain version against the Pallas kernel in interpret
    mode and against ``admm_chunk_xla``."""
    a = admm_chunk_inputs(8, 6, 9, seed=1, equality_row=True, loose_row=True)
    launches = ak.admm_chunk_launches
    s, yp, stats = ak.admm_chunk(*(_t(a[k]) for k in CHUNK_ARGS), alpha=1.6, seg=5)
    jargs = [jnp.asarray(a[k]) for k in CHUNK_ARGS]
    jp = jax_ak.admm_chunk_pallas(*jargs, alpha=1.6, seg=5, tile=8, interpret=True)
    jx = jax_ak.admm_chunk_xla(*jargs, alpha=1.6, seg=5)
    for ref in (jp, jx):
        for got, want in zip((s, yp, stats), ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.abs(s.numpy() - a["s"]).max() > 1e-3  # the chunk moved the state
    assert ak.admm_chunk_launches == launches  # CPU tensors take the plain version


def test_admm_chunk_checks_shapes():
    a = admm_chunk_inputs(2, 3, 4, seed=2)
    args = [_t(a[k]) for k in CHUNK_ARGS]
    with pytest.raises(ValueError, match="W has shape"):
        ak.admm_chunk(args[0][:, :-1], *args[1:], alpha=1.0, seg=1)
    with pytest.raises(ValueError, match="CUDA"):  # the launcher takes CUDA tensors only
        ak.admm_chunk_kernel(*args, alpha=1.0, seg=1)


def test_schur_factor_matches_jax_and_fails_with_nan():
    """W and Minv to 1e-9; a problem whose Schur matrix is not SPD comes
    out NaN in both packages (the fused tier's failure test)."""
    a = qp_inputs(4, 5, 7, seed=3)
    P = a["P"].copy()
    P[2] = -10.0 * np.eye(5)
    rho_vec = np.full((4, 7), 0.1)
    rho_vec[:, 0] = 100.0
    W, Minv = _schur_factor(_t(P), _t(a["A"]), 1e-6, _t(rho_vec))
    jf = jax_schur_factor(jnp.asarray(P), jnp.asarray(a["A"]), 1e-6, jnp.asarray(rho_vec))
    for k, got in (("W", W.numpy()), ("Minv", Minv.numpy())):
        want = np.asarray(jf[k])
        assert np.isnan(got[2]).all() and np.isnan(want[2]).all()
        np.testing.assert_allclose(np.delete(got, 2, 0), np.delete(want, 2, 0), atol=ATOL,
                                   rtol=0, err_msg=k)
    assert torch.isnan(W).flatten(1).any(-1).tolist() == [False, False, True, False]


def test_infeasibility_certificates_match_jax():
    """Deltas along each problem's certificate (primal: dy = e0 - e1 on the
    two contradictory rows; dual: dx = the null direction d) and random
    deltas, on feasible, primal- and dual-infeasible problems."""
    a = certificate_qp_inputs(6, 5, seed=4)
    rng = np.random.default_rng(4)
    dx = 1e-3 * rng.standard_normal((6, 5))
    dy = 1e-3 * rng.standard_normal((6, 7))
    for i in (1, 4):
        dy[i] = 0.0
        dy[i, 0], dy[i, 1] = 1.0, -1.0
    for i in (2, 5):
        dx[i] = a["A"][i, -1]  # the last row is d itself
    args = [a[k] for k in ("P", "A", "q", "l", "u")] + [dx, dy]
    prim, dual = infeasibility_certificates(*map(_t, args), 1e-4, 1e-4)
    jprim, jdual = jax_certificates(*map(jnp.asarray, args), 1e-4, 1e-4)
    np.testing.assert_array_equal(prim.numpy(), np.asarray(jprim))
    np.testing.assert_array_equal(dual.numpy(), np.asarray(jdual))
    assert prim.tolist() == [False, True, False] * 2
    assert dual.tolist() == [False, False, True] * 2


def test_anderson_extrapolate_matches_jax():
    """Problems with no history, a partial ring and a full ring."""
    rng = np.random.default_rng(5)
    B, mem, dim = 4, 3, 10
    aa = anderson_init((B,), mem, dim, torch.float64)
    aa = dict(aa, dU=_t(rng.standard_normal((B, mem, dim))),
              dF=_t(rng.standard_normal((B, mem, dim))),
              uT_prev=_t(rng.standard_normal((B, dim))), f_prev=_t(rng.standard_normal((B, dim))),
              prev_ok=_t([False, True, True, True]), pairs=_t(np.array([0, 1, 2, 3], np.int32)))
    u_in, u_T = rng.standard_normal((B, dim)), rng.standard_normal((B, dim))
    got = anderson_extrapolate(aa, _t(u_in), _t(u_T), mem)
    jaa = {k: jnp.asarray(v.numpy()) for k, v in aa.items()}
    want = jax_anderson(jaa, jnp.asarray(u_in), jnp.asarray(u_T), mem)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for k in got[2]:
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(want[2][k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    assert got[1].tolist() == [0, 2, 3, 3]


# ---------------------------------------------------------------------------
# qp_solve_batch(impl="fused")
# ---------------------------------------------------------------------------


def _qp_case(name):
    """(inputs, settings, warm) of one parity case, B <= 8, n <= 10."""
    if name == "cold_fixed":
        return qp_inputs(6, 8, 10, seed=11), BENCH, False
    if name == "warm":  # and the early-exit schedule
        return qp_inputs(6, 8, 10, seed=13), dict(BENCH, schedule="early_exit"), True
    if name == "batch_of_5":
        return qp_inputs(5, 8, 10, seed=14, loose_row=True), BENCH, True
    if name == "infeasible":
        return certificate_qp_inputs(6, 8, seed=7), BENCH, False
    if name == "comp_slack":
        return qp_inputs(6, 8, 10, seed=15), dict(BENCH, check_comp_slack=True), False
    if name == "anderson":
        return qp_inputs(6, 8, 10, seed=16), dict(BENCH, acceleration="anderson",
                                                 eps_abs=1e-7, eps_rel=1e-7), False
    if name == "polish":
        return qp_inputs(6, 8, 10, seed=17, loose_row=True), dict(BENCH, polish=True), False
    raise KeyError(name)


QP_CASES = ["cold_fixed", "warm", "batch_of_5", "infeasible", "comp_slack",
            "anderson", "polish"]


@pytest.mark.parametrize("name", QP_CASES)
def test_qp_solve_fused_matches_jax(name):
    a, settings, warm = _qp_case(name)
    jq = JaxQP(*(jnp.asarray(a[k]) for k in LEAVES))
    jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy")) if warm else None
    jr = jax_qp_solve_fused(jq, JaxQPSettings(**settings), jst, backend="xla")
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu") if warm else None
    pr = qp_solve_batch(pq, QPSettings(**settings), state=pst, impl="fused")
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    rtol = ATOL if name == "infeasible" else 0
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(pr, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=ATOL, rtol=rtol, err_msg=k)
    for k in ("res_prim", "res_dual"):
        np.testing.assert_allclose(getattr(pr.info, k).numpy(), np.asarray(getattr(jr.info, k)),
                                   atol=ATOL, rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(pr.info.rho_estimate.numpy(), np.asarray(jr.info.rho_estimate),
                               rtol=1e-6)
    status = pr.info.status.numpy()
    if name == "infeasible":
        np.testing.assert_array_equal(status, [QPStatus.SOLVED, QPStatus.PRIMAL_INFEASIBLE,
                                               QPStatus.DUAL_INFEASIBLE] * 2)
    else:
        assert (status == QPStatus.SOLVED).all()


def test_qp_solve_fused_agrees_with_the_kernel_tier():
    """The fused tier and the whole-QP kernel tier (K3) solve the same
    random QPs to the same point within the ADMM tolerance, and the fused
    tier's NaN-factor problem reports NUMERICAL_ISSUES."""
    a = qp_inputs(6, 8, 10, seed=18)
    a["P"][3] = -10.0 * np.eye(8)
    pq = interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu")
    fused = qp_solve_batch(pq, QPSettings(**BENCH), impl="fused")
    assert fused.info.status[3] == QPStatus.NUMERICAL_ISSUES
    keep = [0, 1, 2, 4, 5]
    kern = qp_solve_batch(interop.qp_from_arrays(*(a[k][keep] for k in LEAVES), device="cpu"),
                          QPSettings(**BENCH), impl="kernel")
    assert (fused.info.status[keep] == QPStatus.SOLVED).all()
    np.testing.assert_allclose(fused.x[keep].numpy(), kern.x.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# sqp_solve_batch(impl="fused") with qp_impl="fused"
# ---------------------------------------------------------------------------

SQP_CASES = {
    "default": SQPSettings(),
    "bench_kkt": FUSED,
    "bench_soc_step_norm": dataclasses.replace(
        FUSED, second_order_correction=True, termination="step_norm", schedule="early_exit",
        max_iter=6, record_trace=True),
}


@pytest.mark.parametrize("name", sorted(SQP_CASES))
def test_fused_sqp_matches_jax(name):
    """The sphere cap, B = 4, n = 6: default settings (qp_impl="fused",
    early exit, no polish), and the bench settings with polish, without SOC
    under kkt termination and with SOC under step-norm termination."""
    settings = SQP_CASES[name]
    _, jr, _, pr = _solve_both(4, 6, 2, settings, np.float64)
    for k in ("status", "iter", "qp_solver_iter"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=1e-8, rtol=0)
    if settings.record_trace:
        for k in ("x", "alpha", "primal_step_norm"):
            np.testing.assert_allclose(pr.trace[k].numpy(), np.asarray(jr.trace[k]),
                                       atol=1e-8, err_msg=k)
    if name in ("default", "bench_kkt"):
        assert (pr.info.status.numpy() == SQPStatus.SOLVED).all()


def test_fused_sqp_portfolio_autodiff_matches_jax():
    """The portfolio objective of examples/portfolio_nlp.py (risk, return
    and a smoothed w^1.5 impact cost) under sum(w) = 1, 0 <= w <= cap, with
    no derivative hooks: gradients, Jacobians and the polish Hessian come
    from torch.func in the port and jax autodiff in the reference."""
    B, N = 4, 6
    rng = np.random.default_rng(0)
    F = rng.normal(size=(N, N)) / np.sqrt(N)
    S = F @ F.T + 0.05 * np.eye(N)
    mu = rng.uniform(0.0, 0.1, (B, N))
    gamma, c_imp, cap = 5.0, 0.05, 0.4
    Sj, St = jnp.asarray(S), torch.as_tensor(S)

    def jobj(w, m):
        impact = jnp.sum((jnp.maximum(w, 0.0) + 1e-3) ** 1.5)
        return -m @ w + gamma * (w @ (Sj @ w)) + c_imp * impact

    def jcon(w, m):
        return jnp.concatenate([jnp.array([jnp.sum(w)]), w])

    def pobj(w, m):
        impact = ((torch.maximum(w, torch.zeros_like(w)) + 1e-3) ** 1.5).sum(-1)
        return -(m * w).sum(-1) + gamma * ((w @ St) * w).sum(-1) + c_imp * impact

    def pcon(w, m):
        return torch.cat([w.sum(-1, keepdim=True), w], dim=-1)

    l = np.concatenate([np.ones((B, 1)), np.zeros((B, N))], 1)
    u = np.concatenate([np.ones((B, 1)), np.full((B, N), cap)], 1)
    settings = SQPSettings(
        max_iter=8, eps_prim=1e-2, eps_dual=1e-2, termination="kkt", schedule="fixed",
        polish=True, qp=QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=150,
                                   check_termination=25, warm_start=True, adaptive_rho=True,
                                   adaptive_rho_interval=50, schedule="fixed"))
    x0 = np.full((B, N), 1.0 / N)
    jr = jax_sqp_solve_batch(
        JaxNonlinearProblem(l=jnp.asarray(l), u=jnp.asarray(u), params=jnp.asarray(mu),
                            objective=jobj, constraint=jcon),
        jnp.asarray(x0), None, to_jax_settings(settings), impl="fused")
    pr = sqp_solve_batch(NonlinearProblem(l=_t(l), u=_t(u), params=_t(mu), objective=pobj,
                                          constraint=pcon), _t(x0), None, settings, impl="fused")
    for k in ("status", "iter", "qp_solver_iter"):
        np.testing.assert_array_equal(getattr(pr.info, k).numpy(),
                                      np.asarray(getattr(jr.info, k)), err_msg=k)
    assert (pr.info.status.numpy() == SQPStatus.SOLVED).all()
    np.testing.assert_allclose(pr.x.numpy(), np.asarray(jr.x), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.lam.numpy(), np.asarray(jr.lam), atol=1e-8, rtol=0)
    np.testing.assert_allclose(pr.x.numpy().sum(-1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the batch-first polish epilogue
# ---------------------------------------------------------------------------


def _sphere_adapters(layout):
    """(f_lin, c_lin, hess) of the sphere cap, in
    ``layout``: "torch" batch-first, "jax" batch-first, "jax_t" the JAX
    kernel tier's (J (m, n, B), H (n, n, B))."""
    if layout == "torch":
        def f_lin(x):
            return -x.sum(-1), -torch.ones_like(x)

        def c_lin(x):
            B, n = x.shape
            eye = torch.eye(n, dtype=x.dtype).expand(B, n, n)
            return torch.cat([(x * x).sum(-1, keepdim=True), x], -1), torch.cat(
                [2.0 * x.unsqueeze(1), eye], dim=1)

        def hess(x, lam):
            return torch.eye(x.shape[-1], dtype=x.dtype) * (2.0 * lam[:, 0])[:, None, None]

        return f_lin, c_lin, hess

    def f_lin(x):
        return -x.sum(-1), -jnp.ones_like(x)

    def c_lin(x):
        B, n = x.shape
        J = jnp.concatenate([2.0 * x[:, None, :], jnp.broadcast_to(jnp.eye(n), (B, n, n))], 1)
        c = jnp.concatenate([jnp.sum(x * x, -1, keepdims=True), x], -1)
        return (c, J) if layout == "jax" else (c, jnp.moveaxis(J, 0, -1))

    def hess(x, lam):
        H = jnp.eye(x.shape[-1]) * (2.0 * lam[:, 0])[:, None, None]
        return H if layout == "jax" else jnp.moveaxis(H, 0, -1)

    return f_lin, c_lin, hess


def _polish_point(B, n, seed):
    """A sphere-cap point near the optimum with rough multipliers."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.6, 0.9, B) * np.sqrt(n)
    x = (r / np.sqrt(n))[:, None] * np.ones((B, n)) + 1e-3 * rng.standard_normal((B, n))
    lam = np.zeros((B, n + 1))
    lam[:, 0] = np.sqrt(n) / (2.0 * r) * (1.0 + 1e-2 * rng.standard_normal(B))
    l = np.zeros((B, n + 1))
    u = np.concatenate([(r ** 2)[:, None], np.ones((B, n))], 1)
    return x, lam, l, u


@pytest.mark.parametrize("n", [6, 130], ids=["polish_nlp", "polish_nlp_t_n130"])
def test_polish_nlp_matches_jax(n):
    """The port's one batch-first epilogue against both JAX epilogues:
    n = 6 against JAX's polish_nlp, n = 130 (past the TPU kernel's
    n = 128 envelope, where the port's kernel takes its workspace route)
    against JAX's polish_nlp_t with the kernel layout adapters."""
    B = 4 if n == 6 else 2
    x, lam, l, u = _polish_point(B, n, seed=n)
    # two passes at n = 6 (the second reuses the first's scoring), one at n = 130
    settings = dataclasses.replace(FUSED, polish_passes=2 if n == 6 else 1)
    pf, pc, ph = _sphere_adapters("torch")
    px, plam, pres = common.polish_nlp(_t(x), _t(lam), _t(l), _t(u), pf, pc, ph, settings)
    layout = "jax" if n == 6 else "jax_t"
    jf, jc, jh = _sphere_adapters(layout)
    jax_fn = jax_common.polish_nlp if n == 6 else jax_common.polish_nlp_t
    jx, jlam, jres = jax_fn(jnp.asarray(x), jnp.asarray(lam), jnp.asarray(l), jnp.asarray(u),
                            jf, jc, jh, settings)
    np.testing.assert_array_equal(pres.numpy(), np.asarray(jres))
    assert pres.all()
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(plam.numpy(), np.asarray(jlam), atol=ATOL, rtol=0)
    assert np.abs(px.numpy() - x).max() > 1e-4  # the polish moved the point


def test_kernel_tier_polishes_above_n_128():
    """SQP polish at n = 129 on the kernel tier, under the n = 128 bench
    settings (bench.py:352-369), runs (it raised before the batch-first
    route was ported) and takes the unpolished 4.6e-2 error to the closed
    form's float64 neighbourhood."""
    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch, sphere_cap_solution

    pp, px0 = sphere_cap_nlp_batch(2, 129, seed=0, dtype=torch.float64, device="cpu")
    k2 = qk.polish_kkt_launches
    settings = dataclasses.replace(HEADLINE, max_iter=2, polish_passes=3, polish_sweeps=4)
    res = sqp_solve_batch(pp, px0, None, settings, impl="fused")
    assert qk.polish_kkt_launches == k2  # the plain version on the CPU
    assert (res.info.status.numpy() == SQPStatus.SOLVED).all()
    assert np.abs(res.x.numpy() - sphere_cap_solution(pp)).max() < 1e-8


# ---------------------------------------------------------------------------
# sustained serving over the fused tier
# ---------------------------------------------------------------------------


def test_qp_solve_sequence_fused_matches_jax():
    """K = 3 warm-started steps of the MPC fleet through impl="fused"."""
    mpc = dict(BENCH)
    f = _fleet()
    x0 = _plant0()
    pm, pa = _port_fleet()
    jm, ja = _jax_fleet(f)
    (px, pit, pst, prms), pcarry, pstate = qp_solve_sequence(
        pm, pa, torch.as_tensor(x0), 3, QPSettings(**mpc), impl="fused")
    (jx, jit, jst, jrms), jcarry, jstate = jax_qp_solve_sequence(
        jm, ja, jnp.asarray(x0), 3, JaxQPSettings(**mpc), impl="fused")
    np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst))
    assert (pst.numpy() == QPStatus.SOLVED).all()
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pcarry.numpy(), np.asarray(jcarry), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pstate.y.numpy(), np.asarray(jstate.y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(prms.numpy(), np.asarray(jrms), atol=ATOL, rtol=0)


def test_sqp_solve_sequence_fused_matches_jax():
    """One cold solve hands (x, lam) to K = 2 warm steps, qp_impl="fused"."""
    from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch as jax_sphere_cap

    n, batch = 6, 4
    jp, jx0 = jax_sphere_cap(batch, n, seed=5, dtype=jnp.float64)
    r0 = np.array(jp.params)
    jset = to_jax_settings(FUSED)

    def jmake(r):
        l = jnp.zeros((batch, n + 1))
        u = jnp.concatenate([(r ** 2)[:, None], jnp.ones((batch, n))], axis=1)
        return dataclasses.replace(jp, l=l, u=u, params=r), jnp.full((batch, n), 0.25)

    jres0 = jax_sqp_solve_batch(jmake(jnp.asarray(r0))[0], jx0, None, jset, impl="fused")
    (jxs, jsts), _, (_, jlam_f) = jax_sqp_solve_sequence(
        jmake, lambda r, res: (0.98 * r, (res.x, res.info.status)), 0.98 * jnp.asarray(r0), 2,
        dataclasses.replace(jset, max_iter=1), impl="fused", warm0=(jres0.x, jres0.lam))
    make_nlp, _ = _port_nlp(n)
    pr0 = torch.as_tensor(r0)
    pres0 = sqp_solve_batch(make_nlp(pr0)[0], torch.as_tensor(np.array(jx0)), None, FUSED,
                            impl="fused")
    (pxs, psts), _, (_, plam_f) = sqp_solve_sequence(
        make_nlp, lambda r, res: (0.98 * r, (res.x, res.info.status)), 0.98 * pr0, 2,
        dataclasses.replace(FUSED, max_iter=1), impl="fused", warm0=(pres0.x, pres0.lam))
    np.testing.assert_array_equal(psts.numpy(), np.asarray(jsts))
    assert (psts.numpy() == 0).all()
    np.testing.assert_allclose(pxs.numpy(), np.asarray(jxs), atol=1e-8, rtol=0)
    np.testing.assert_allclose(plam_f.numpy(), np.asarray(jlam_f), atol=1e-8, rtol=0)
