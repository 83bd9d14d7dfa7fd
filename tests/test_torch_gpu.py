"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where torch sees no CUDA
device.  The file imports no JAX (``tests/conftest.py`` does), so on the
card's machine it runs without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances.  On inputs shaped like the main path's subproblems (no
equality rows: an equality row's multiplier integrates rounding with
rho_eq = 1e3 rho, which makes float32 trajectories part ways), float32
kernel against float32 plain version, summed in another order:
atol = rtol = 1e-4, with ADMM iteration counts agreeing on >= 99 % of
problems and iterates compared where they do.  Where a rho adopted from
a ratio of residual norms (~1e-3 relative float32 noise) drives a
refactor, the kernel and the plain version in float32 are both held to
float32 bars against the plain version in float64.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqp_solver_tpu_torch.ops import qp_kernel as qk  # noqa: E402
from sqp_solver_tpu_torch.qp.types import QPSettings  # noqa: E402
from sqp_solver_tpu_torch.qp.types import QuadraticProblem, QPState, QPStatus  # noqa: E402
from sqp_solver_tpu_torch.testing import (  # noqa: E402
    certificate_qp_inputs,
    polish_inputs,
    qp_inputs,
    spd_inputs,
    step_inputs,
)

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-4, rtol=1e-4)
MAIN_QP = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                     check_termination=10, warm_start=True, adaptive_rho=True,
                     adaptive_rho_interval=50, schedule="fixed")
# two rho epochs: the adaptive rho is adopted with a refactor, and many
# problems converge (early exit) part way
EPOCHS_QP = QPSettings(alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, max_iter=40,
                       check_termination=10, adaptive_rho=True,
                       adaptive_rho_interval=20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with --noconftest -m gpu")
    return torch.device("cuda")


def _to(arrs, device):
    out = {}
    for k, v in arrs.items():
        dt = torch.bool if v.dtype == bool else torch.float32
        out[k] = torch.as_tensor(v, dtype=dt).to(device)
    return out


def _step(fn, t, settings, **kw):
    return fn(t["B"], t["J"], t["g"], t["l"], t["u"], t["s"], t["dgl"], t["reset"],
              t["upd"], t["active"], t["x"], t["z"], t["y"], settings, **kw)


def _assert_step_close(ok, ref):
    assert torch.equal(ok.fail.cpu(), ref.fail.cpu())
    same = (ok.iter == ref.iter).cpu()
    assert same.float().mean().item() >= 0.99
    good = (same & ~ref.fail.cpu()).to(ok.p.device)
    for name in ("p", "z", "y", "B", "rho_factor"):
        a, b = getattr(ok, name)[good], getattr(ref, name)[good]
        torch.testing.assert_close(a, b, **TOL, msg=lambda m, name=name: f"{name}: {m}")
    if ok.minv is not None:
        torch.testing.assert_close(ok.minv[good], ref.minv[good], **TOL)


@pytest.mark.parametrize(
    "batch,n,m",
    [(16, 6, 9), (64, 32, 33), (8, 128, 129), (4, 64, 900), (16, 50, 51), (8, 100, 101)],
    ids=["small", "n32", "n128", "workspace-spill", "n50-partial-panel", "n100-partial-panel"],
)
@pytest.mark.parametrize("do_bfgs", [True, False])
def test_sqp_step_kernel_matches_plain(cuda, batch, n, m, do_bfgs):
    t = _to(step_inputs(batch, n, m, seed=n + m, equality_row=False), cuda)
    ok = _step(qk.sqp_step_kernel, t, MAIN_QP, do_bfgs=do_bfgs, want_minv=True)
    ref = _step(qk.sqp_step_reference, t, MAIN_QP, do_bfgs=do_bfgs, want_minv=True)
    torch.cuda.synchronize()
    _assert_step_close(ok, ref)
    assert not ok.fail.any()
    if batch > 4:  # problem 3's indefinite Hessian took the posdef fallback
        assert torch.equal(ok.B[3], torch.eye(n, device=cuda))
        assert int(ok.n_factor[3]) == 2


@pytest.mark.parametrize("batch,n,m", [(128, 16, 17), (64, 128, 129)], ids=["n16", "n128"])
def test_sqp_step_kernel_refactors_match_plain_float64(cuda, batch, n, m):
    """Rho epochs with refactors and early exits, against the plain version
    in float64.  An adopted rho carries ~1e-3 relative float32 noise, so
    the bars are float32's: iterates 1e-4, Minv 1e-3, the adopted rho 5e-2
    relative; the plain version in float32 must meet them too."""
    arrs = step_inputs(batch, n, m, seed=7, equality_row=False)
    arrs = {k: v if v.dtype == bool else v.astype(np.float32) for k, v in arrs.items()}
    t32 = _to(arrs, cuda)
    t64 = {k: v if v.dtype == torch.bool else v.double() for k, v in t32.items()}
    ok = _step(qk.sqp_step_kernel, t32, EPOCHS_QP, want_minv=True)
    p32 = _step(qk.sqp_step_reference, t32, EPOCHS_QP, want_minv=True)
    p64 = _step(qk.sqp_step_reference, t64, EPOCHS_QP, want_minv=True)
    torch.cuda.synchronize()
    assert int(p64.n_factor.max()) >= 2 and bool(p64.done.any())
    tols = dict(p=1e-4, z=1e-4, y=1e-4, minv=1e-3)
    for out in (ok, p32):
        same = (out.iter == p64.iter) & (out.rho_updates == p64.rho_updates)
        assert same.float().mean() >= 0.99
        for name, tol in tols.items():
            torch.testing.assert_close(getattr(out, name)[same].double(),
                                       getattr(p64, name)[same], atol=tol, rtol=tol)
        torch.testing.assert_close(out.rho_factor[same].double(), p64.rho_factor[same],
                                   atol=0.0, rtol=5e-2)


def test_sqp_step_kernel_factor_reuse(cuda):
    """want_minv then minv_in with shifted bounds (the SOC re-solve)."""
    t = _to(step_inputs(32, 16, 17, seed=3, equality_row=False), cuda)
    first = _step(qk.sqp_step_kernel, t, MAIN_QP, want_minv=True)
    t2 = dict(t, B=first.B, l=t["l"] - 0.01, u=t["u"] - 0.01, x=first.p, z=first.z,
              y=first.y)
    kw = dict(do_bfgs=False, rho_in=first.rho_factor, minv_in=first.minv)
    ok = _step(qk.sqp_step_kernel, t2, MAIN_QP, **kw)
    ref = _step(qk.sqp_step_reference, t2, MAIN_QP, **kw)
    torch.cuda.synchronize()
    _assert_step_close(ok, ref)
    # no setup factorization on the reuse path
    assert int(ok.n_factor.max()) == int(ref.n_factor.max())


@pytest.mark.parametrize(
    "batch,n,m",
    [(16, 8, 11), (64, 32, 33), (8, 128, 129), (16, 50, 51), (8, 100, 101), (4, 160, 161)],
    ids=["small", "n32", "n128", "n50-partial-panel", "n100-partial-panel", "workspace-spill"],
)
@pytest.mark.parametrize("warm", [False, True])
def test_polish_kkt_kernel_matches_plain(cuda, batch, n, m, warm):
    t = _to(polish_inputs(batch, n, m, seed=n), cuda)
    x0 = t["x0"] if warm else None
    args = (t["H"], t["J"], t["act"], t["r1"], t["b"], t["nu0"])
    ok = qk.polish_kkt_kernel(*args, delta=1e-2, sweeps=6, x0=x0)
    ref = qk.polish_kkt_reference(*args, delta=1e-2, sweeps=6, x0=x0)
    torch.cuda.synchronize()
    assert torch.equal(ok.fail, ref.fail)
    assert bool(ok.fail[0]) and not ok.fail[1:].any()
    good = ~ref.fail
    torch.testing.assert_close(ok.x[good], ref.x[good], **TOL)
    torch.testing.assert_close(ok.nu[good], ref.nu[good], **TOL)
    torch.testing.assert_close(ok.li[good], ref.li[good], **TOL)


def test_polish_kkt_factor_reuse_matches_plain(cuda):
    """K2's reuse instantiation (n = 128, m = 129): on an unchanged mask it
    gives the fresh kernel's outputs bit for bit (the previous L^-1 and fail
    flag, the same sweeps); with ~10 % of the masks changed and new
    right-hand sides it matches the plain version with reuse at 1e-4, the
    clamped pivot of problem 0 kept by fail_prev; one launch counted each."""
    t = _to(polish_inputs(64, 128, 129, seed=4), cuda)
    args = [t[k] for k in ("H", "J", "act", "r1", "b", "nu0")]
    first = qk.polish_kkt_kernel(*args, delta=1e-2, sweeps=4, x0=t["x0"])
    before = qk.polish_kkt_launches
    again = qk.polish_kkt_kernel(*args, delta=1e-2, sweeps=4, x0=t["x0"], act_prev=t["act"],
                                 li_prev=first.li, fail_prev=first.fail)
    torch.cuda.synchronize()
    assert qk.polish_kkt_launches == before + 1
    for name in ("x", "nu", "fail", "li"):
        a, b = getattr(first, name), getattr(again, name)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b), name
    act_prev = t["act"].clone()
    act_prev[::10, 0] = ~act_prev[::10, 0]
    new = dict(r1=t["r1"] + 0.3, b=torch.where(t["act"], t["b"] - 0.2, 0.0))
    args2 = [t["H"], t["J"], t["act"], new["r1"], new["b"], t["nu0"]]
    kw = dict(delta=1e-2, sweeps=4, x0=t["x0"], act_prev=act_prev, li_prev=first.li,
              fail_prev=first.fail)
    ok = qk.polish_kkt_kernel(*args2, **kw)
    ref = qk.polish_kkt_reference(*args2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ok.fail, ref.fail) and bool(ok.fail[0]) and not ok.fail[1:].any()
    for name in ("x", "nu", "li"):
        torch.testing.assert_close(getattr(ok, name)[1:], getattr(ref, name)[1:], **TOL,
                                   msg=lambda msg, name=name: f"{name}: {msg}")


def test_dense_factor_matches_blocked_twin(cuda):
    """K2's L^-1 and K1's emitted Minv against the plain twin of the
    kernels' blocked order (``_chol_inv_blocked``) at n = 128, on the
    kernels' own Schur matrices."""
    n, m = 128, 129
    p = _to(polish_inputs(8, n, m, seed=5), cuda)
    ok = qk.polish_kkt_kernel(p["H"], p["J"], p["act"], p["r1"], p["b"], p["nu0"], delta=1e-2,
                              sweeps=1)
    actf = p["act"].float()
    Jm = p["J"] * actf.unsqueeze(-1)
    Li, fail = qk._chol_inv_blocked(qk._schur_matrix(p["H"], Jm, actf * 1e2, 1e-2), ltl=False)
    torch.cuda.synchronize()
    assert torch.equal(ok.fail, fail) and bool(fail[0]) and not fail[1:].any()
    torch.testing.assert_close(ok.li[1:], Li[1:], **TOL)
    s = _to(step_inputs(8, n, m, seed=6, equality_row=False), cuda)
    settings = dataclasses.replace(MAIN_QP, max_iter=10, adaptive_rho=False)
    out = _step(qk.sqp_step_kernel, s, settings, do_bfgs=False, want_minv=True)
    rv = qk._rho_from(out.rho_factor, (s["l"] < -1e16) & (s["u"] > 1e16), (s["u"] - s["l"]) < 1e-4)
    Minv, f = qk._chol_inv_blocked(qk._schur_matrix(out.B, s["J"], rv, settings.sigma))
    torch.cuda.synchronize()
    assert not f.any() and int(out.n_factor[3]) == 2  # B := I on problem 3
    act = s["active"]
    torch.testing.assert_close(out.minv[act], Minv[act], **TOL)


def test_launch_counters_count_cuda_launches_only(cuda):
    t = _to(step_inputs(8, 6, 7, seed=1), cuda)
    tc = {k: v.cpu() for k, v in t.items()}
    k1, k2 = qk.sqp_step_launches, qk.polish_kkt_launches
    _step(qk.sqp_step_kernel, tc, MAIN_QP)
    assert qk.sqp_step_launches == k1
    _step(qk.sqp_step_kernel, t, MAIN_QP)
    assert qk.sqp_step_launches == k1 + 1
    p = _to(polish_inputs(8, 6, 7, seed=1), cuda)
    qk.polish_kkt_kernel(p["H"], p["J"], p["act"], p["r1"], p["b"], p["nu0"])
    assert qk.polish_kkt_launches == k2 + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    t = _to(step_inputs(8, 6, 7, seed=1), cuda)
    with pytest.raises(TypeError):
        _step(qk.sqp_step_kernel, dict(t, g=t["g"].double()), MAIN_QP)
    with pytest.raises(ValueError):
        _step(qk.sqp_step_kernel, dict(t, x=t["x"].cpu()), MAIN_QP)
    with pytest.raises(ValueError):
        _step(qk.sqp_step_kernel, dict(t, J=t["J"].mT.contiguous().mT), MAIN_QP)


def test_solver_on_cuda_matches_cpu_plain_path(cuda):
    """The whole slice on the card (kernels) against the same solve on the
    CPU (plain versions): same statuses, solutions within f32 noise."""
    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    settings = SQPSettings(max_iter=3, eps_prim=2e-3, eps_dual=2e-3, termination="kkt",
                           schedule="fixed", qp_impl="kernel", polish=True,
                           polish_passes=2, line_search_max_iter=5, qp=MAIN_QP)
    res = {}
    for dev in ("cpu", cuda):
        prob, x0 = sphere_cap_nlp_batch(64, 16, seed=4, dtype=torch.float32, device=dev)
        res[str(dev)] = sqp_solve_batch(prob, x0, None, settings, impl="fused")
    a, b = res["cpu"], res["cuda"]
    np.testing.assert_array_equal(a.info.status.numpy(), b.info.status.cpu().numpy())
    np.testing.assert_allclose(b.x.cpu().numpy(), a.x.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# K3 whole-QP kernel, K4 SPD-inverse kernel, the QP polish routes
# ---------------------------------------------------------------------------

# the one-shot QP leg's settings (bench.py:814-818): 4 rho epochs
QP_BENCH = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200,
                      check_termination=25, adaptive_rho=True, adaptive_rho_interval=50,
                      schedule="fixed")
QP_ONE_EPOCH = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200,
                          check_termination=25, adaptive_rho=False, schedule="fixed")
LEAVES = ("P", "q", "A", "l", "u")


def _qp(t):
    return QuadraticProblem(*(t[k] for k in LEAVES)), QPState(t["x"], t["z"], t["y"])


def _qp_raw(fn, t, settings):
    return fn(*(t[k] for k in ("P", "A", "q", "l", "u", "x", "z", "y")), settings)


QP_SHAPES = [(64, 32, 33), (64, 16, 32), (8, 128, 129), (4, 64, 900)]
QP_IDS = ["n32", "n16", "n128", "workspace-spill"]


@pytest.mark.parametrize("batch,n,m", QP_SHAPES, ids=QP_IDS)
def test_qp_solve_kernel_matches_plain_one_epoch(cuda, batch, n, m):
    """One rho epoch: kernel against plain float32 at 1e-4."""
    t = _to(qp_inputs(batch, n, m, seed=n + m, loose_row=True), cuda)
    ok = _qp_raw(qk._qp_solve_launch, t, QP_ONE_EPOCH)
    ref = _qp_raw(qk.qp_solve_reference, t, QP_ONE_EPOCH)
    torch.cuda.synchronize()
    assert torch.equal(ok.fail, ref.fail) and not ok.fail.any()
    assert torch.equal(ok.infs, ref.infs)
    same = ok.iter == ref.iter
    assert same.float().mean().item() >= 0.99
    for name in ("x", "z", "y"):
        torch.testing.assert_close(getattr(ok, name)[same], getattr(ref, name)[same], **TOL)


@pytest.mark.parametrize("batch,n,m", QP_SHAPES[:3], ids=QP_IDS[:3])
def test_qp_solve_kernel_epochs_match_plain_float64(cuda, batch, n, m):
    """Four rho epochs: kernel and plain float32 each against plain
    float64 at 5e-4 (an adopted rho carries ~1e-3 relative float32 noise;
    the float32 and float64 trajectories part by up to ~1e-4, the ADMM's
    termination tolerance, before they stop at the same iteration)."""
    arrs = qp_inputs(batch, n, m, seed=3 * n, dtype=np.float32)
    t32 = _to(arrs, cuda)
    t64 = {k: v.double() for k, v in t32.items()}
    ok = _qp_raw(qk._qp_solve_launch, t32, QP_BENCH)
    p32 = _qp_raw(qk.qp_solve_reference, t32, QP_BENCH)
    p64 = _qp_raw(qk.qp_solve_reference, t64, QP_BENCH)
    torch.cuda.synchronize()
    assert p64.done.float().mean() >= 0.9 and int(p64.rho_updates.max()) >= 2
    for out in (ok, p32):
        same = (out.iter == p64.iter) & (out.rho_updates == p64.rho_updates)
        assert torch.equal(out.done[same], p64.done[same])
        assert same.float().mean() >= 0.99
        for name in ("x", "z", "y"):
            torch.testing.assert_close(getattr(out, name)[same].double(),
                                       getattr(p64, name)[same], atol=5e-4, rtol=5e-4)


def test_qp_certificates_kernel_status_equals_plain(cuda):
    """Feasible, primal- and dual-infeasible problems: equal statuses."""
    t = _to(certificate_qp_inputs(96, 8, seed=5), cuda)
    qp, _ = _qp(t)
    ok = qk.qp_solve_kernel(qp, QP_BENCH)
    ref = qk.qp_solve_kernel(QuadraticProblem(*(v.cpu() for v in (qp.P, qp.q, qp.A, qp.l,
                                                                   qp.u))), QP_BENCH)
    torch.cuda.synchronize()
    st = ok.info.status.cpu()
    assert torch.equal(st, ref.info.status)
    want = torch.tensor([QPStatus.SOLVED, QPStatus.PRIMAL_INFEASIBLE,
                         QPStatus.DUAL_INFEASIBLE] * 32, dtype=torch.int32)
    assert torch.equal(st, want)


def test_qp_nan_reaches_the_fail_flag(cuda):
    a = qp_inputs(4, 6, 7, seed=2, dtype=np.float32)
    a["q"][0, 0] = np.nan
    a["q"][1, 3] = np.nan
    qp, _ = _qp(_to(a, cuda))
    st = qk.qp_solve_kernel(qp, QP_BENCH).info.status.cpu().tolist()
    assert st == [QPStatus.NUMERICAL_ISSUES, QPStatus.NUMERICAL_ISSUES, QPStatus.SOLVED,
                  QPStatus.SOLVED]


@pytest.mark.parametrize(
    "batch,n,m,warp",
    [(64, 32, 33, True), (64, 16, 32, True), (63, 32, 64, True), (33, 5, 40, True),
     (32, 33, 34, False), (32, 16, 65, False)],
    ids=["n32-m33", "n16-m32", "n32-m64", "n5-m40-odd-batch", "n33-block", "m65-block"],
)
def test_qp_solve_layouts_match_plain_one_epoch(cuda, batch, n, m, warp):
    """K3's warp layout (one warp a problem, n <= 32 and m <= 64) and its
    block layout: the rule picks the expected one, and each layout the shape
    takes agrees with the plain version at 1e-4 on one rho epoch."""
    t = _to(qp_inputs(batch, n, m, seed=n + 2 * m, loose_row=True), cuda)
    per = qk.qp_solve_problems_per_block(n, m)
    assert (per > 1) == warp
    ref = _qp_raw(qk.qp_solve_reference, t, QP_ONE_EPOCH)
    layouts = ["block", "warp"] if warp else ["block"]
    outs = [_qp_raw(qk._qp_solve_launch, t, QP_ONE_EPOCH)]
    outs += [_qp_raw(lambda *a: qk._qp_solve_launch(*a, layout=lay), t, QP_ONE_EPOCH)
             for lay in layouts]
    torch.cuda.synchronize()
    for ok in outs:
        assert torch.equal(ok.fail, ref.fail) and not ok.fail.any()
        assert torch.equal(ok.infs, ref.infs)
        same = ok.iter == ref.iter
        assert same.float().mean().item() >= 0.99
        for name in ("x", "z", "y"):
            torch.testing.assert_close(getattr(ok, name)[same], getattr(ref, name)[same], **TOL)
    if not warp:
        with pytest.raises(RuntimeError):
            _qp_raw(lambda *a: qk._qp_solve_launch(*a, layout="warp"), t, QP_ONE_EPOCH)


@pytest.mark.parametrize("batch,n,m", [(64, 16, 32), (64, 6, 7), (64, 32, 64), (96, 8, 10)],
                         ids=["n16-m32", "n6-m7", "n32-m64", "certificates"])
def test_qp_warp_layout_equals_block_layout_bit_for_bit(cuda, batch, n, m):
    """Four rho epochs with early exits: the warp layout runs the block
    layout's per-element operations (the factor's, and each dot product's
    fmaf chain) and so returns its outputs bit for bit, where no row of A
    goes lane-split (m <= 32 or m > 36)."""
    if m == n + 2:
        t = _to(certificate_qp_inputs(batch, n, seed=5), cuda)
    else:
        t = _to(qp_inputs(batch, n, m, seed=n * m, loose_row=True), cuda)
    outs = [_qp_raw(lambda *a: qk._qp_solve_launch(*a, layout=lay), t, QP_BENCH)
            for lay in ("warp", "block")]
    torch.cuda.synchronize()
    for name, a, b in zip(outs[0]._fields, *outs):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("layout", ["block", "warp"])
def test_qp_certificates_and_nan_in_both_layouts(cuda, layout):
    """The certificate batch and the NaN-to-fail-flag case through each
    layout of K3: statuses equal the plain version's."""
    t = _to(certificate_qp_inputs(96, 8, seed=5), cuda)
    ok = qk.qp_status(_qp_raw(lambda *a: qk._qp_solve_launch(*a, layout=layout), t, QP_BENCH))
    ref = qk.qp_status(_qp_raw(qk.qp_solve_reference, {k: v.cpu() for k, v in t.items()},
                               QP_BENCH))
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), ref)
    assert set(ref.tolist()) == {QPStatus.SOLVED, QPStatus.PRIMAL_INFEASIBLE,
                                 QPStatus.DUAL_INFEASIBLE}
    a = qp_inputs(4, 6, 7, seed=2, dtype=np.float32)
    a["q"][0, 0] = np.nan
    a["q"][1, 3] = np.nan
    a.update(x=np.zeros((4, 6), np.float32), z=np.zeros((4, 7), np.float32),
             y=np.zeros((4, 7), np.float32))
    st = qk.qp_status(_qp_raw(lambda *a: qk._qp_solve_launch(*a, layout=layout),
                              _to(a, cuda), QP_BENCH)).cpu().tolist()
    assert st == [QPStatus.NUMERICAL_ISSUES, QPStatus.NUMERICAL_ISSUES, QPStatus.SOLVED,
                  QPStatus.SOLVED]


@pytest.mark.parametrize(
    "batch,n",
    [(64, 5), (64, 16), (63, 31), (64, 32), (16, 33), (16, 50), (8, 100), (8, 128), (3, 256)],
    ids=["n5", "n16", "n31", "n32", "n33-partial-panel", "n50-partial-panel",
         "n100-partial-panel", "n128", "workspace-spill"],
)
def test_spd_inverse_kernel_matches_plain(cuda, batch, n):
    """K4 under its rule (the warp layout at n <= 32, the blocked layout in
    place above; at n = 256 its one matrix lives in the workspace) against
    the plain version, with a non-SPD problem 0."""
    M = _to(spd_inputs(batch, n, seed=n), cuda)["M"]
    Minv, fail = qk.spd_inverse_kernel(M)
    ref, rfail = qk.spd_inverse_reference(M)
    torch.cuda.synchronize()
    assert torch.equal(fail, rfail) and bool(fail[0]) and not fail[1:].any()
    torch.testing.assert_close(Minv[1:], ref[1:], **TOL)
    assert (qk._library().spd_inverse_workspace_floats(n) > 0) == (n > 240)


@pytest.mark.parametrize("n", [64, 128])
def test_spd_inverse_kernel_matches_blocked_twin(cuda, n):
    """K4's blocked layout sums in the blocked order: fail flags equal to
    the plain twin of that order (``_chol_inv_blocked``), Minv within 1e-4."""
    M = _to(spd_inputs(16, n, seed=n + 3), cuda)["M"]
    Minv, fail = qk.spd_inverse_kernel(M)
    ref, rfail = qk._chol_inv_blocked(M)
    torch.cuda.synchronize()
    assert torch.equal(fail, rfail) and bool(fail[0]) and not fail[1:].any()
    torch.testing.assert_close(Minv[1:], ref[1:], **TOL)


@pytest.mark.parametrize("n", [8, 17, 32])
def test_spd_inverse_warp_layout_equals_column_bit_for_bit(cuda, n):
    """The warp layout runs the column factor's per-element operations
    (K3's warp factor), so its Minv and fail flags are the column kernel's
    bit for bit (the NaN-free clamped values of the non-SPD problem 0
    included)."""
    M = _to(spd_inputs(37, n, seed=2 * n), cuda)["M"]
    assert qk.spd_inverse_arm_info(n)["arm"] == "warp"
    col = qk._spd_inverse_launch(M, arm="column")
    out = qk.spd_inverse_kernel(M)
    torch.cuda.synchronize()
    assert torch.equal(out[1], col[1]) and bool(out[1][0])
    assert torch.equal(out[0].view(torch.int32), col[0].view(torch.int32))


@pytest.mark.parametrize("n", [32, 50, 100, 128])
def test_spd_inverse_arms_match_plain(cuda, n):
    """Both A/B arms of the raw launcher agree with the plain version; past
    n = 32 the rule's blocked layout in place equals the two-buffer arm bit
    for bit (the same fmaf chain for every element), also at n = 100 and
    128, where a block row has several sum and scale tasks, a warp several
    L^T L tasks, and (n = 100) the last panel is partial."""
    M = _to(spd_inputs(16, n, seed=n + 5), cuda)["M"]
    ref, rfail = qk.spd_inverse_reference(M)
    outs = {}
    for arm in qk.SPD_ARMS:
        outs[arm] = qk._spd_inverse_launch(M, arm=arm)
        torch.cuda.synchronize()
        assert torch.equal(outs[arm][1], rfail) and bool(rfail[0]), arm
        torch.testing.assert_close(outs[arm][0][1:], ref[1:], **TOL)
    if n > 32:
        Minv, fail = qk.spd_inverse_kernel(M)
        torch.cuda.synchronize()
        assert qk.spd_inverse_arm_info(n)["arm"] == "blocked"
        assert torch.equal(fail, outs["two-buffer"][1])
        assert torch.equal(Minv.view(torch.int32), outs["two-buffer"][0].view(torch.int32))
    with pytest.raises(ValueError):
        qk._spd_inverse_launch(M, arm="blocked")


def test_spd_inverse_layout_rule(cuda):
    """One warp a problem, eight a block, at n <= 32; one block a problem
    above, with three blocks an SM at n = 128 (66 KB of shared memory)."""
    assert qk.spd_inverse_problems_per_block(32) == 8
    assert qk.spd_inverse_problems_per_block(33) == 1
    warp, blocked = qk.spd_inverse_arm_info(32), qk.spd_inverse_arm_info(128)
    assert (warp["arm"], warp["threads"], warp["local_bytes"]) == ("warp", 256, 0)
    assert (blocked["arm"], blocked["threads"]) == ("blocked", 128)
    assert blocked["smem_bytes"] == 128 * 129 * 4 + 1024 and blocked["blocks_per_sm"] == 3


def _kkt_err64(qp, res):
    """float64 max(stationarity, bound violation) per problem."""
    P, q, A, l, u = (getattr(qp, k).double().cpu() for k in LEAVES)
    x, y = res.x.double().cpu(), res.y.double().cpu()
    Ax = (A @ x[..., None])[..., 0]
    stat = ((P @ x[..., None])[..., 0] + q + (A.mT @ y[..., None])[..., 0]).abs().amax(-1)
    viol = torch.clamp_min(torch.maximum(l - Ax, Ax - u).amax(-1), 0.0)
    return torch.maximum(stat, viol)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_qp_polish_routes_on_cuda(cuda, use_kernel):
    """polish_qp on the card, one pass: the K2 route (default) or the K4
    route (kkt_solve_schur_refined(use_kernel=False)), each launched once,
    against the same call on the CPU (plain versions, float32) where both
    took the same accept decision (>= 95 % of problems), and the float64
    KKT error p99 far below the unpolished one."""
    from sqp_solver_tpu_torch.qp import polish_qp

    arrs = qp_inputs(256, 16, 17, seed=9, loose_row=True, dtype=np.float32)
    qp, _ = _qp(_to(arrs, cuda))
    loose = QPSettings(alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, max_iter=200,
                       check_termination=25, adaptive_rho=True, adaptive_rho_interval=50,
                       polish_passes=1)
    res = qk.qp_solve_kernel(qp, loose)
    k2, k4 = qk.polish_kkt_launches, qk.spd_inverse_launches
    pol = polish_qp(qp, res, loose, use_kernel=use_kernel)
    want = (1, 0) if use_kernel is None else (0, 1)
    assert (qk.polish_kkt_launches - k2, qk.spd_inverse_launches - k4) == want
    qpc = QuadraticProblem(*(getattr(qp, k).cpu() for k in LEAVES))
    resc = type(res)(x=res.x.cpu(), y=res.y.cpu(), z=res.z.cpu(), info=res.info)
    ref = polish_qp(qpc, resc, loose, use_kernel=use_kernel)
    torch.cuda.synchronize()
    moved = (pol.x.cpu() != resc.x).any(-1)
    same = moved == (ref.x != resc.x).any(-1)
    assert same.float().mean() >= 0.95 and moved.float().mean() >= 0.5
    torch.testing.assert_close(pol.x.cpu()[same], ref.x[same], atol=1e-3, rtol=1e-3)
    before = torch.quantile(_kkt_err64(qp, res), 0.99)
    after = torch.quantile(_kkt_err64(qp, pol), 0.99)
    assert after < 0.1 * before, (float(before), float(after))


def test_qp_launch_counters_count_cuda_launches_only(cuda):
    t = _to(qp_inputs(8, 6, 7, seed=1), cuda)
    qp, st = _qp(t)
    k3, k4 = qk.qp_solve_launches, qk.spd_inverse_launches
    qk.qp_solve_kernel(QuadraticProblem(*(v.cpu() for v in (qp.P, qp.q, qp.A, qp.l, qp.u))),
                       QP_BENCH)
    qk.spd_inverse_kernel(_to(spd_inputs(4, 5), "cpu")["M"])
    assert (qk.qp_solve_launches, qk.spd_inverse_launches) == (k3, k4)
    qk.qp_solve_kernel(qp, QP_BENCH, st)
    qk.spd_inverse_kernel(_to(spd_inputs(4, 5), cuda)["M"])
    assert (qk.qp_solve_launches, qk.spd_inverse_launches) == (k3 + 1, k4 + 1)


def test_qp_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    t = _to(qp_inputs(8, 6, 7, seed=1), cuda)
    qp, st = _qp(t)
    with pytest.raises(TypeError):
        qk.qp_solve_kernel(QuadraticProblem(qp.P.double(), qp.q, qp.A, qp.l, qp.u), QP_BENCH)
    with pytest.raises(ValueError):
        qk.qp_solve_kernel(QuadraticProblem(qp.P, qp.q, qp.A.cpu(), qp.l, qp.u), QP_BENCH)
    with pytest.raises(ValueError):
        qk.qp_solve_kernel(QuadraticProblem(qp.P.mT, qp.q, qp.A, qp.l, qp.u), QP_BENCH)
    with pytest.raises(ValueError):
        qk.qp_solve_kernel(qp, QP_BENCH, QPState(st.x[:, :-1], st.z, st.y))
    M = _to(spd_inputs(4, 5), cuda)["M"]
    with pytest.raises(TypeError):
        qk.spd_inverse_kernel(M.double())
    with pytest.raises(ValueError):
        qk.spd_inverse_kernel(M.mT)
    with pytest.raises(ValueError):
        qk.spd_inverse_kernel(M[:, :, :-1])


def test_qp_serving_on_cuda_matches_cpu_plain_path(cuda):
    """qp_solve_batch(impl="kernel") and a short qp_solve_sequence on the
    card against the same calls on the CPU: equal statuses, solutions
    within float32 noise."""
    from sqp_solver_tpu_torch.models.mpc import mpc_qp_batch, random_qp_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    res = {}
    for dev in ("cpu", cuda):
        res[str(dev)] = qp_solve_batch(random_qp_batch(128, 32, 33, seed=4, device=dev),
                                       QP_BENCH, impl="kernel")
    a, b = res["cpu"], res["cuda"]
    assert torch.equal(a.info.status, b.info.status.cpu())
    np.testing.assert_allclose(b.x.cpu().numpy(), a.x.numpy(), atol=1e-4)
    qp = mpc_qp_batch(128, seed=2, device=cuda)
    st = qp_solve_batch(qp, QP_BENCH, impl="kernel").info.status
    assert bool((st == QPStatus.SOLVED).all())


# ---------------------------------------------------------------------------
# K5 ADMM chunk kernel and the fused tier
# ---------------------------------------------------------------------------

CHUNK_ARGS = ("W", "P", "A", "qv", "scale1", "rhoip", "rhop", "lp", "up", "s", "yp")


@pytest.mark.parametrize(
    "batch,n,m,seg,nan_w",
    [(256, 32, 33, 10, False), (256, 32, 33, 25, False), (256, 16, 32, 25, False),
     (64, 128, 129, 10, False), (8, 400, 401, 5, False), (33, 17, 20, 7, False),
     (17, 32, 33, 0, False), (17, 32, 33, 1, False), (9, 128, 129, 1, False),
     (12, 100, 180, 3, False), (6, 500, 600, 5, False), (2, 1024, 1024, 3, False),
     (5, 513, 600, 4, False), (3, 600, 620, 5, False), (5, 700, 500, 0, False),
     (5, 700, 500, 1, False), (4, 513, 600, 3, True), (4, 145, 144, 3, False),
     (5, 300, 301, 4, False), (6, 256, 256, 5, False), (7, 256, 256, 3, False),
     (5, 256, 256, 0, False), (5, 256, 256, 1, False), (4, 256, 256, 3, True),
     (3, 360, 600, 4, False), (3, 512, 512, 3, False), (2, 1062, 1063, 3, False),
     (3, 1062, 1063, 0, False)],
    ids=["D65-seg10", "D65-seg25", "D48", "D257-rows-in-registers", "D801", "D37-odd-batch",
         "seg0", "seg1", "D257-seg1", "D280-rows-in-registers", "D1100-wide",
         "D2048", "D1113-odd-wide", "D1220-B3-cluster8", "D1200-seg0", "D1200-seg1",
         "D1113-nan-W", "D289-odd", "D601-odd", "D512", "D512-odd-batch", "D512-seg0",
         "D512-seg1", "D512-nan-W", "D960-control", "D1024", "D2125", "D2125-seg0"],
)
def test_admm_chunk_kernel_matches_plain(cuda, batch, n, m, seg, nan_w):
    """One chunk, float32 kernel against float32 plain version at 1e-4, on
    the route the layout rule takes.  At D = 257 and 280 part of W does
    not fit in shared memory and is held in registers (the narrow route).
    From D = 289 to 1024 the cluster route where a portable cluster's
    shared memory holds W (D = 289, 512, 601: W on chip for the whole
    chunk), else the stream route (D = 801, 960, 1024).  At an odd D no
    problem's W after the first starts 16-byte aligned (4-byte copies in
    the narrow kernel; in the ring bulk copies of the aligned window and
    the head or tail at W's ends by one thread).  Past D = 1024 the stream
    route (B = 3: clusters of 8), up to the JAX kernel's limit D = 2125.
    With ``nan_w`` one problem's W holds a NaN (a failed factor): its
    outputs are NaN where the plain version's are, the other problems'
    are unaffected."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    t = _to(admm_chunk_inputs(batch, n, m, seed=n + seg), cuda)
    if nan_w:
        t["W"][1, 7, 11] = float("nan")
    args = [t[k] for k in CHUNK_ARGS]
    before = ak.admm_chunk_launches
    ok = ak.admm_chunk_kernel(*args, alpha=1.6, seg=seg)
    ref = ak.admm_chunk_reference(*args, alpha=1.6, seg=seg)
    torch.cuda.synchronize()
    assert ak.admm_chunk_launches == before + 1
    for name, a, b in zip(("s", "yp", "stats"), ok, ref):
        torch.testing.assert_close(a, b, **TOL, equal_nan=nan_w,
                                   msg=lambda msg, name=name: f"{name}: {msg}")
    if nan_w:
        assert bool(ok[0][1].isnan().any()) and bool(ok[2][1].isnan().all())
        others = [i for i in range(batch) if i != 1]
        assert all(bool(torch.isfinite(x[others]).all()) for x in ok)
    lay = ak.admm_chunk_layout(n, m, batch)
    assert lay["smem_rows"] == ak.admm_chunk_smem_rows(n, m, batch)
    assert lay["smem_rows"] + lay["register_rows"] + lay["device_rows"] == n + m
    if n + m <= 288:  # the narrow route: what shared memory cannot hold, registers do
        assert lay["route"] == "narrow" and lay["device_rows"] == 0
        assert (lay["register_rows"] > 0) == (n + m in (257, 280))
    elif lay["route"] == "cluster":  # W on chip over the cluster for the whole chunk
        assert n + m in (289, 512, 601)
        assert lay["smem_rows"] == n + m and lay["register_rows"] == lay["device_rows"] == 0
    else:  # every row of W streams from device memory every iteration
        assert lay["route"] == "stream" and lay["device_rows"] == n + m
    if n + m > 1024:
        _assert_wide_layout(ak, n, m, batch, cuda)


def _assert_wide_layout(ak, n, m, batch, cuda, cluster=0):
    """The wide layout the kernel reports equals its Python mirror: the
    cluster, the stages (one a consumer warp) of whole rows of W, shared
    memory a block within 227 KB, and the runtime holding the blocks an SM
    that the layout counts on."""
    card = ak.admm_chunk_layout(n, m, batch, cluster=cluster, device=cuda)
    assert card["route"] == "stream"
    mirror = ak.admm_chunk_wide_layout(n, m, batch, cluster, sms=card["sms"])
    for key in ("cluster", "threads", "stages", "stage_floats", "rows_stage", "smem_bytes",
                "blocks_per_sm", "rows_max", "prow_max"):
        assert card[key] == mirror[key], key
    assert card["stages"] == 8 and card["rows_stage"] >= 1
    assert mirror["stage_bytes"] >= 4 * (card["rows_stage"] * (n + m) + 6)
    assert card["smem_bytes"] <= 232448
    assert card["resident"] >= card["blocks_per_sm"]
    if cluster == 0:
        c = card["cluster"]
        assert (batch * c <= card["sms"] or c == 1) and (c == 8 or 2 * batch * c > card["sms"])


def test_admm_chunk_wide_unaligned_operands_match_plain(cuda):
    """W, P and A as views that start one float into their storage (16-byte
    unaligned, as a sliced tensor is): the wide variant's bulk copies keep
    inside each operand and copy the head and tail at its ends with plain
    loads, and the outputs equal the plain version's."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    t = _to(admm_chunk_inputs(3, 520, 511, seed=5), cuda)
    for key in ("W", "P", "A"):
        flat = torch.empty(t[key].numel() + 1, device=cuda)
        view = flat[1:].view(t[key].shape)
        view.copy_(t[key])
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        t[key] = view
    args = [t[k] for k in CHUNK_ARGS]
    ok = ak.admm_chunk_kernel(*args, alpha=1.6, seg=4)
    ref = ak.admm_chunk_reference(*args, alpha=1.6, seg=4)
    torch.cuda.synchronize()
    for name, a, b in zip(("s", "yp", "stats"), ok, ref):
        torch.testing.assert_close(a, b, **TOL, msg=lambda msg, name=name: f"{name}: {msg}")


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_admm_chunk_wide_clusters_match_plain(cuda, cluster):
    """Each cluster size the wide variant takes, forced, against the plain
    version at an odd D (rows split unevenly over the blocks, A and P rows
    over up to eight blocks, every problem's W but the first unaligned)."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    batch, n, m, seg = 3, 517, 531, 3
    t = _to(admm_chunk_inputs(batch, n, m, seed=cluster), cuda)
    args = [t[k] for k in CHUNK_ARGS]
    ok = ak._admm_chunk_launch(*args, alpha=1.6, seg=seg, cluster=cluster)
    ref = ak.admm_chunk_reference(*args, alpha=1.6, seg=seg)
    torch.cuda.synchronize()
    for name, a, b in zip(("s", "yp", "stats"), ok, ref):
        torch.testing.assert_close(a, b, **TOL, msg=lambda msg, name=name: f"{name}: {msg}")
    _assert_wide_layout(ak, n, m, batch, cuda, cluster)


def test_admm_chunk_wrappers(cuda):
    """CPU tensors take the plain version through admm_chunk (no launch);
    the launcher refuses float64, a CPU operand and a transposed view."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    t = _to(admm_chunk_inputs(4, 5, 6, seed=1), cuda)
    args = [t[k] for k in CHUNK_ARGS]
    before = ak.admm_chunk_launches
    ak.admm_chunk(*(a.cpu() for a in args), alpha=1.6, seg=3)
    assert ak.admm_chunk_launches == before
    ak.admm_chunk(*args, alpha=1.6, seg=3)
    assert ak.admm_chunk_launches == before + 1
    with pytest.raises(TypeError):
        ak.admm_chunk_kernel(args[0].double(), *args[1:], alpha=1.6, seg=3)
    with pytest.raises(ValueError):
        ak.admm_chunk_kernel(*args[:-1], args[-1].cpu(), alpha=1.6, seg=3)
    with pytest.raises(ValueError):
        ak.admm_chunk_kernel(args[0].mT, *args[1:], alpha=1.6, seg=3)
    # a cluster is the wide variant's, of 1, 2, 4 or 8 blocks: refused
    # unlaunched, and the C entry refuses what the wrapper would not pass
    with pytest.raises(ValueError, match="cluster"):
        ak._admm_chunk_launch(*args, alpha=1.6, seg=3, cluster=2)
    assert ak.admm_chunk_launches == before + 1
    from sqp_solver_tpu_torch.ops import _build
    from sqp_solver_tpu_torch.ops.qp_kernel import _ptr

    lib = _build.load()
    w = _to(admm_chunk_inputs(1, 600, 500, seed=2), cuda)
    wargs = [w[k] for k in CHUNK_ARGS]
    outs = [torch.empty_like(wargs[-2]), torch.empty_like(wargs[-1]),
            torch.empty((1, 4), device=cuda)]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    import ctypes

    for route, bad in ((0, 3), (0, 16), (ak.ROUTES["narrow"], 0), (ak.ROUTES["cluster"], 8)):
        rc = lib.admm_chunk_launch_as(route, bad, *map(_ptr, wargs + outs), 1, 600, 500, 1.6,
                                      -0.6, 3, cuda.index or 0, ctypes.c_void_p(stream), None)
        assert rc != 0
    # D = 2126: past the JAX kernel's limit, refused unlaunched
    n, m = 1063, 1063
    big = [torch.zeros((1, n + m, n + m), device=cuda), torch.zeros((1, n, n), device=cuda),
           torch.zeros((1, m, n), device=cuda)] + [torch.zeros((1, n + m), device=cuda)] * 8
    before = ak.admm_chunk_launches
    with pytest.raises(ValueError, match="exceeds 2125"):
        ak.admm_chunk_kernel(*big, alpha=1.6, seg=3)
    assert ak.admm_chunk_launches == before


def _chunk_check(ak, cuda, batch, n, m, seg, seed, route=None, cluster=None):
    """One launch (the route and cluster forced where given) against the
    plain version at 1e-4; returns the layout it took."""
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    t = _to(admm_chunk_inputs(batch, n, m, seed=seed), cuda)
    args = [t[k] for k in CHUNK_ARGS]
    ak.reset_route_counts()
    ok = ak._admm_chunk_launch(*args, alpha=1.6, seg=seg, route=route, cluster=cluster)
    ref = ak.admm_chunk_reference(*args, alpha=1.6, seg=seg)
    torch.cuda.synchronize()
    for name, a, b in zip(("s", "yp", "stats"), ok, ref):
        torch.testing.assert_close(a, b, **TOL, msg=lambda msg, name=name: f"{name}: {msg}")
    lay = ak.admm_chunk_layout(n, m, batch, route, cluster or 0)
    assert ak.route_counts() == {k: int(k == lay["route"]) for k in ak.ROUTES}
    return lay


def _largest_cluster_d(ak):
    """The largest D (n = D // 2) that the layout rule puts on the cluster route."""
    return max(d for d in range(289, 1025) if ak.admm_chunk_layout(d // 2, d - d // 2, 1024)[
        "route"] == "cluster")


def test_admm_chunk_route_rule_on_the_card(cuda):
    """The layout rule through its C entry (``admm_chunk_route_layout``)
    over D = 2-2125: narrow up to 288, the cluster route from 289 wherever
    a portable cluster holds W and the stream route elsewhere; on the
    cluster route W is on chip (no row from device memory), the clusters'
    row ranges cover D, a block's shared memory fits 227 KB, its stages
    hold its rows (ceil(rows / 8) a stage), the runtime holds the blocks an
    SM the layout counts on, and no smaller portable cluster holds W with
    as many blocks an SM; where the stream route is taken below D = 1025,
    no portable cluster holds W."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak

    for D in list(range(2, 300, 7)) + list(range(289, 1025, 13)) + [512, 640, 641, 960, 1024,
                                                                      1025, 2048, 2049, 2125]:
        for n in sorted({max(1, D // 8), D // 2, D - max(1, D // 8)}):
            m = D - n
            if n < 1 or m < 1:
                continue
            lay = ak.admm_chunk_layout(n, m, 1024)
            assert lay["route"] == ("narrow" if D <= 288 else "stream" if D > 1024 else
                                    lay["route"]), (n, m)
            assert lay["smem_rows"] + lay["register_rows"] + lay["device_rows"] == D
            if lay["route"] == "narrow":
                continue
            c = lay["cluster"]
            ranges = [(D * r // c, D * (r + 1) // c) for r in range(c)]
            assert max(r1 - r0 for r0, r1 in ranges) == lay["rows_max"] == -(-D // c)
            assert lay["smem_bytes"] <= 232448 and lay["resident"] >= lay["blocks_per_sm"] >= 1
            assert lay["active_clusters"] >= 1
            portable = {}
            for k in (2, 4, 8):
                try:
                    portable[k] = ak.admm_chunk_layout(n, m, 1024, "cluster", k)["blocks_per_sm"]
                except ValueError:
                    pass
            if lay["route"] == "cluster":
                assert lay["device_rows"] == 0 and lay["smem_rows"] == D
                assert lay["stages"] * lay["rows_stage"] >= lay["rows_max"]
                # the fewest blocks a problem with two blocks an SM, else the fewest
                assert c in portable and all(k >= c or portable[k] < portable[c]
                                             for k in portable)
                assert portable[c] == 2 or all(v == 1 for v in portable.values())
            else:
                assert lay["device_rows"] == D and not portable


def test_admm_chunk_largest_cluster_d_and_the_next_match_plain(cuda):
    """The largest D the cluster route takes (n = D // 2), with W on chip,
    and the next D, which streams W: each against the plain version."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak

    D = _largest_cluster_d(ak)
    assert 600 <= D < 700
    lay = _chunk_check(ak, cuda, 5, D // 2, D - D // 2, 4, seed=D)
    assert lay["route"] == "cluster" and lay["device_rows"] == 0
    lay = _chunk_check(ak, cuda, 5, (D + 1) // 2, D + 1 - (D + 1) // 2, 4, seed=D + 1)
    assert lay["route"] == "stream" and lay["device_rows"] == D + 1


@pytest.mark.parametrize("n,m", [(145, 144), (256, 256)], ids=["D289-odd", "D512"])
def test_admm_chunk_forced_routes_match_plain(cuda, n, m):
    """Every route and cluster that fits, forced, against the plain version:
    the narrow kernel (rows of W it cannot hold from device memory), the
    cluster route at 2, 4, 8 and 16 blocks a problem (16: a non-portable
    cluster) and the stream route at 1, 2, 4 and 8; those that do not fit
    are refused unlaunched."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    fitted = []
    for route, c in ([("narrow", None)] + [("cluster", k) for k in (2, 4, 8, 16)]
                     + [("stream", k) for k in (1, 2, 4, 8)]):
        try:
            ak.admm_chunk_layout(n, m, 3, route, c or 0)
        except ValueError:
            before = ak.admm_chunk_launches
            t = _to(admm_chunk_inputs(3, n, m, seed=1), cuda)
            with pytest.raises(ValueError, match="does not fit"):
                ak._admm_chunk_launch(*[t[k] for k in CHUNK_ARGS], alpha=1.6, seg=3,
                                      route=route, cluster=c)
            assert ak.admm_chunk_launches == before
            continue
        lay = _chunk_check(ak, cuda, 3, n, m, 3, seed=n + (c or 0), route=route, cluster=c)
        assert lay["route"] == route and (c is None or lay["cluster"] == c)
        fitted.append((route, c))
    want_cluster = {289: (2, 4, 8, 16), 512: (8, 16)}[n + m]
    assert [c for r, c in fitted if r == "cluster"] == list(want_cluster)
    assert [c for r, c in fitted if r == "stream"] == [1, 2, 4, 8]
    assert ("narrow", None) in fitted


def test_admm_chunk_refuses_what_does_not_fit(cuda):
    """A forced route or cluster that does not fit is refused unlaunched
    with a clear error: the cluster route where its blocks cannot hold W,
    the stream route at D <= 288, the narrow kernel past D = 1024, a
    cluster of 16 on the stream route, a cluster that is no power of two,
    and a route that does not exist; and D = 2126, past the JAX kernel's
    limit."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    def launch(n, m, **kw):
        t = _to(admm_chunk_inputs(2, n, m, seed=3), cuda)
        return ak._admm_chunk_launch(*[t[k] for k in CHUNK_ARGS], alpha=1.6, seg=2, **kw)

    before = ak.admm_chunk_launches
    for n, m, kw in ((256, 256, dict(route="cluster", cluster=4)),
                     (360, 600, dict(route="cluster")), (100, 100, dict(route="stream")),
                     (600, 500, dict(route="narrow")), (600, 500, dict(cluster=16)),
                     (256, 256, dict(cluster=3))):
        with pytest.raises(ValueError, match="does not fit"):
            launch(n, m, **kw)
    with pytest.raises(ValueError, match="route"):
        launch(256, 256, route="tiles")
    assert ak.admm_chunk_launches == before
    with pytest.raises(ValueError, match="exceeds 2125"):
        ak.admm_chunk_layout(1063, 1063, 1)
    n, m = 1063, 1063
    big = [torch.zeros((1, n + m, n + m), device=cuda), torch.zeros((1, n, n), device=cuda),
           torch.zeros((1, m, n), device=cuda)] + [torch.zeros((1, n + m), device=cuda)] * 8
    with pytest.raises(ValueError, match="exceeds 2125"):
        ak.admm_chunk_kernel(*big, alpha=1.6, seg=3)
    assert ak.admm_chunk_launches == before


@pytest.mark.parametrize("batch,n,m", [(256, 32, 33), (256, 16, 32), (32, 128, 129)],
                         ids=["n32", "n16", "n128"])
def test_qp_solve_fused_on_cuda_matches_plain_float64(cuda, batch, n, m):
    """qp_solve_batch(impl="fused") on the card (K5 in float32, 4 rho
    epochs) and the same solve on the CPU in float64: statuses agree, and
    where iteration and rho-update counts agree (>= 99 % of problems) the
    iterates agree to 5e-4 (an adopted rho carries ~1e-3 relative float32
    noise; the trajectories part by up to the ADMM tolerance)."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    arrs = qp_inputs(batch, n, m, seed=5 * n, dtype=np.float32)
    qp32, _ = _qp(_to(arrs, cuda))
    qp64 = QuadraticProblem(*(getattr(qp32, k).double().cpu() for k in LEAVES))
    before = ak.admm_chunk_launches
    r32 = qp_solve_batch(qp32, QP_BENCH, impl="fused")
    torch.cuda.synchronize()
    assert ak.admm_chunk_launches == before + 8  # 200 iterations in chunks of 25
    r64 = qp_solve_batch(qp64, QP_BENCH, impl="fused")
    assert int(r64.info.rho_updates.max()) >= 2
    assert torch.equal(r32.info.status.cpu(), r64.info.status)
    same = ((r32.info.iter.cpu() == r64.info.iter)
            & (r32.info.rho_updates.cpu() == r64.info.rho_updates))
    assert same.float().mean() >= 0.99
    for k in ("x", "z", "y"):
        torch.testing.assert_close(getattr(r32, k).cpu()[same].double(),
                                   getattr(r64, k)[same], atol=5e-4, rtol=5e-4)


def test_fused_sqp_on_cuda_matches_cpu_plain_path(cuda):
    """sqp_solve_batch with qp_impl="fused" on the card (K5, K2) against
    the same solve on the CPU (plain versions): same statuses, solutions
    within float32 noise; K5 launched 5 chunks per outer iteration."""
    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    settings = SQPSettings(max_iter=3, eps_prim=2e-3, eps_dual=2e-3, termination="kkt",
                           schedule="fixed", qp_impl="fused", polish=True,
                           polish_passes=2, line_search_max_iter=5, qp=MAIN_QP)
    res = {}
    for dev in ("cpu", cuda):
        prob, x0 = sphere_cap_nlp_batch(64, 16, seed=4, dtype=torch.float32, device=dev)
        k5, k2 = ak.admm_chunk_launches, qk.polish_kkt_launches
        res[str(dev)] = sqp_solve_batch(prob, x0, None, settings, impl="fused")
        launches = (ak.admm_chunk_launches - k5, qk.polish_kkt_launches - k2)
        assert launches == ((0, 0) if dev == "cpu" else (15, 2))
    a, b = res["cpu"], res["cuda"]
    np.testing.assert_array_equal(a.info.status.numpy(), b.info.status.cpu().numpy())
    assert (a.info.status == 0).all()
    np.testing.assert_allclose(b.x.cpu().numpy(), a.x.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# K6 / K7: the block-tridiagonal whole-QP kernel
# ---------------------------------------------------------------------------

BTD_QP = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200, check_termination=25,
                    adaptive_rho=False, schedule="fixed", linear_solver="schur_block_tridiag",
                    block_size=8)
# (batch, T, bb, m, blocks per problem: None for the launcher's rule,
# launches).  The first three are the first kernel's shapes, one launch at
# seed T + m each; the others pool as many launches, each with its own
# seed, as make at least 100 problems.  The rule takes a cluster of two
# blocks at n = 192 and where 2 B <= SMs (B <= 66 on a 132-SM card), one
# block otherwise (T16-B128, bb24, bb32); 1 forces one block.
BTD_SHAPES = [
    pytest.param(64, 2, 8, 12, None, 1, id="small"),
    pytest.param(128, 24, 8, 320, 1, 1, id="n192-A-split"),
    pytest.param(16, 4, 16, 40, None, 1, id="bb16"),
    pytest.param(64, 2, 8, 12, 1, 2, id="small-block"),
    pytest.param(16, 4, 16, 40, 1, 7, id="bb16-block"),
    pytest.param(128, 24, 8, 320, None, 1, id="n192-m320-B128"),
    pytest.param(8, 24, 8, 320, None, 13, id="n192-m320-B8"),
    pytest.param(64, 24, 8, 320, None, 2, id="n192-m320-B64"),
    pytest.param(8, 24, 8, 336, None, 13, id="n192-m336-B8"),
    pytest.param(64, 24, 8, 336, None, 2, id="n192-m336-B64"),
    pytest.param(64, 24, 8, 336, 1, 2, id="n192-m336-B64-block"),
    pytest.param(32, 16, 8, 224, None, 4, id="T16"),
    pytest.param(128, 16, 8, 224, None, 1, id="T16-B128"),
    pytest.param(128, 3, 24, 60, None, 1, id="bb24"),
    pytest.param(128, 3, 32, 80, None, 1, id="bb32"),
]


def _btd_raw(fn, t, settings, **kw):
    return fn(t["pd"], t["pe"], t["J"], t["g"], t["l"], t["u"], t["x"], t["z"], t["y"],
              settings, **kw)


@pytest.mark.parametrize("batch,T,bb,m,cluster,launches", BTD_SHAPES)
def test_btd_kernel_matches_plain_one_epoch(cuda, batch, T, bb, m, cluster, launches):
    """K7's launch (K6's kernel) on random band QPs without equality rows,
    one rho epoch, a carried rho on every second problem and the last
    problem inactive, with the launcher's block layout or one forced:
    kernel against plain at atol = rtol = 1e-4 where the iteration counts
    agree (>= 99 % of the problems of the shape's launches)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_step_inputs

    s = dataclasses.replace(BTD_QP, block_size=bb)
    agree = []
    for seed in range(T + m, T + m + launches):
        t = _to(btd_step_inputs(batch, T, bb, m, seed=seed), cuda)
        kw = dict(active=t["active"], rho_in=t["rho_in"])
        ok = qb._qp_btd_launch(t["pd"], t["pe"], t["J"], t["g"], t["l"], t["u"], t["x"],
                               t["z"], t["y"], s, t["active"], t["rho_in"], True, "test",
                               cluster=cluster)
        ref = _btd_raw(qb.qp_btd_reference, t, s, check_infeas=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ok.fail, ref.fail) and not ok.fail.any()
        assert torch.equal(ok.done, ref.done)
        same = ok.iter == ref.iter
        agree.append(same)
        for name in ("x", "z", "y", "rho_factor"):
            torch.testing.assert_close(getattr(ok, name)[same], getattr(ref, name)[same], **TOL,
                                       msg=lambda msg, name=name: f"{name}: {msg}")
        assert torch.equal(ok.x[-1], t["x"][-1]) and int(ok.iter[-1]) == 0
    assert torch.cat(agree).float().mean().item() >= 0.99


def test_btd_layout_holds_all_of_a_on_chip(cuda):
    """The launcher's rule: at n = 192 (m = 320 and 336) a cluster of two
    blocks holds all of A in shared memory at every batch; at n = 128,
    m = 224 one block does, and a batch that would leave half of the SMs
    idle takes a cluster; internal blocks 24 and 32 take one block."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    for m in (320, 336):
        for batch in (8, 64, 4096):
            assert qb.cluster_size(192, m, 8, batch) == 2
            assert qb.smem_rows(192, m, 8, batch) == m
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch, blocks in ((sms // 2, 2), (sms // 2 + 1, 1), (1024, 1)):
        assert qb.cluster_size(128, 224, 8, batch) == blocks
        assert qb.smem_rows(128, 224, 8, batch) == 224
    for bb, m in ((24, 60), (32, 80)):
        assert qb.cluster_size(3 * bb, m, bb, 8) == 1 and qb.smem_rows(3 * bb, m, bb, 8) == m


@pytest.mark.parametrize("cluster", [1, 2], ids=["block", "cluster"])
def test_btd_kernel_fail_flag_and_counters(cuda, cluster):
    """An indefinite diagonal block fails the factor (NUMERICAL_ISSUES) on
    the card as in the plain version, with one block and with a cluster of
    two blocks per problem, and through K6's entry point (the launcher's
    layout); K6 and K7 count their own launches; float64 and non-contiguous
    CUDA operands raise."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_qp_inputs, btd_step_inputs

    a = btd_qp_inputs(8, 3, 8, 20, seed=2)
    a["P"][1, 8:16, 8:16] = -10.0 * np.eye(8)
    t = _to(a, cuda)
    pd, pe = qb.extract_band(t["P"], 8)
    zx, zm = torch.zeros_like(t["q"]), torch.zeros_like(t["l"])
    args = (pd, pe, t["A"], t["q"], t["l"], t["u"], zx, zm, zm)
    ok = qb._qp_btd_launch(*args, BTD_QP, None, None, True, "test", cluster=cluster)
    ref = qb.qp_btd_reference(*args, BTD_QP, check_infeas=True)
    torch.cuda.synchronize()
    assert torch.equal(ok.fail, ref.fail) and bool(ok.fail[1]) and not ok.fail[0]
    assert torch.equal(ok.done, ref.done) and torch.equal(ok.infs, ref.infs)
    qp = QuadraticProblem(P=t["P"], q=t["q"], A=t["A"], l=t["l"], u=t["u"])
    k6, k7 = qb.qp_solve_btd_launches, qb.btd_step_launches
    res = qb.qp_solve_kernel_btd(qp, BTD_QP)
    ref = qb.qp_solve_kernel_btd(QuadraticProblem(*(v.cpu() for v in (
        qp.P, qp.q, qp.A, qp.l, qp.u))), BTD_QP)
    torch.cuda.synchronize()
    assert qb.qp_solve_btd_launches == k6 + 1 and qb.btd_step_launches == k7
    assert torch.equal(res.info.status.cpu(), ref.info.status)
    assert int(res.info.status[1]) == QPStatus.NUMERICAL_ISSUES
    s = _to(btd_step_inputs(4, 2, 8, 12, seed=1), cuda)
    args = [s[k] for k in ("pd", "pe", "J", "g", "l", "u", "active", "x", "z", "y")]
    qb.btd_step_kernel(*args, BTD_QP)
    assert qb.btd_step_launches == k7 + 1
    with pytest.raises(TypeError):
        qb.btd_step_kernel(*args[:3], args[3].double(), *args[4:], BTD_QP)
    with pytest.raises(ValueError):
        qb.btd_step_kernel(args[0], args[1], args[2].mT.contiguous().mT, *args[3:], BTD_QP)


def test_btd_kernel_refuses_internal_blocks_over_128(cuda):
    """Internal blocks past 128, which the card once refused, run (the wide
    kernel's compact route): a declared block
    size of 68 (internal block 136) through both entry points, each
    counting one wide launch, against the plain version on the CPU (equal
    statuses, x at atol = rtol = 1e-4 where the iteration counts agree).
    What the card still refuses, with no launch counted, is a shape whose
    vectors do not fit a cluster block's shared memory (n = 5440 at
    bb = 136: wide_layout returns None) and an internal block that is no
    multiple of 8."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_qp_inputs, btd_step_inputs

    s = dataclasses.replace(BTD_QP, block_size=68, max_iter=25)
    assert qb.btd_internal_block(68) == 136 and qb.is_wide(136)
    a = btd_qp_inputs(4, 2, 68, 30, seed=3)
    counts = lambda: (qb.qp_solve_btd_launches, qb.btd_step_launches,  # noqa: E731
                      qb.qp_solve_btd_wide_launches, qb.btd_step_wide_launches)
    before = counts()
    res = {}
    for dev in ("cpu", cuda):
        t = _to(a, dev)
        qp = QuadraticProblem(P=t["P"], q=t["q"], A=t["A"], l=t["l"], u=t["u"])
        res[dev] = qb.qp_solve_kernel_btd(qp, s)
        assert res[dev].x.shape == (4, 136)
    torch.cuda.synchronize()
    assert torch.equal(res[cuda].info.status.cpu(), res["cpu"].info.status)
    same = (res[cuda].info.iter.cpu() == res["cpu"].info.iter)
    assert same.float().mean().item() >= 0.75
    torch.testing.assert_close(res[cuda].x.cpu()[same], res["cpu"].x[same], **TOL)
    st = _to(btd_step_inputs(4, 2, 136, 30, seed=3), cuda)
    args = [st[k] for k in ("pd", "pe", "J", "g", "l", "u", "active", "x", "z", "y")]
    out = qb.btd_step_kernel(*args, s)
    assert bool(torch.isfinite(out.x).all()) and out.band.all()
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    big = dict(pd=torch.zeros(1, 40, 136, 136), pe=torch.zeros(1, 40, 136, 136),
               J=torch.zeros(1, 8, 5440), g=torch.zeros(1, 5440), l=torch.zeros(1, 8),
               u=torch.zeros(1, 8), active=torch.ones(1, dtype=torch.bool),
               x=torch.zeros(1, 5440), z=torch.zeros(1, 8), y=torch.zeros(1, 8))
    big = {k: v.to(cuda) for k, v in big.items()}
    assert qb.wide_layout(5440, 8, 136) is None
    with pytest.raises(ValueError, match="do not fit"):
        qb.btd_step_kernel(*(big[k] for k in ("pd", "pe", "J", "g", "l", "u", "active", "x",
                                              "z", "y")), s)
    with pytest.raises(ValueError, match="multiples of 8"):
        qb.is_wide(12)
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)


# (batch, T, internal block, m, the arrays in device memory): a cluster of
# two blocks per problem holds every array an iteration reads (bb = 40: all
# of them; bb = 64: all but pd and pe); at bb = 128 (T = 2) the sweeps'
# couplings go to the workspace and A's band rows, which an iteration
# reads twice, stay.  Past 128 the compact route: at bb = 136 a cluster of
# four holds A's nonzeros and every matrix of the sweeps (the factor's
# scratch in the workspace); at bb = 256 a matrix outgrows a block, so a
# cluster of eight holds A alone
WIDE_SHAPES = [
    pytest.param(64, 3, 40, 100, [], id="bb40"),
    pytest.param(32, 3, 64, 150, ["pd", "pe"], id="bb64"),
    pytest.param(16, 2, 128, 200, ["GH", "S", "F_prev", "F", "pd", "pe"], id="bb128"),
    pytest.param(16, 2, 136, 160, ["F_prev", "D_part", "E_part"], id="bb136"),
    pytest.param(8, 2, 256, 200, ["G1", "H0", "L0", "L1", "F_prev", "D_part", "E_part"],
                 id="bb256"),
]


@pytest.mark.parametrize("anderson", [False, True], ids=["plain", "anderson"])
@pytest.mark.parametrize("batch,T,bb,m,device", WIDE_SHAPES)
def test_btd_wide_kernel_matches_plain_one_epoch(cuda, batch, T, bb, m, device, anderson):
    """The wide structured kernel on random band QPs without equality rows:
    K7's entry (a carried rho on every second problem, the last problem
    inactive) in its layout's cluster (two up to internal block 128, the
    compact route's rule past it), and K6's, one rho epoch, kernel against
    plain at atol = rtol = 1e-4 where the iteration counts agree (>= 99 %),
    every problem on the band route, each entry counting its wide launch;
    with Anderson acceleration too."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_qp_inputs, btd_step_inputs

    s = dataclasses.replace(BTD_QP, block_size=bb)
    if anderson:
        s = dataclasses.replace(s, check_termination=10, acceleration="anderson",
                                anderson_memory=3)
    n = T * bb
    t = _to(btd_step_inputs(batch, T, bb, m, seed=bb), cuda)
    nnz = qb.compact_nnz(t["J"], bb) if bb > qb.COMPACT_ABOVE else None
    lay = qb.wide_layout(n, m, bb, nnz=nnz)
    assert lay["cluster"] == qb.cluster_size(n, m, bb, batch, nnz=nnz)
    if bb <= qb.COMPACT_ABOVE:
        assert lay["cluster"] == 2 and lay["route"] == "band"
        assert (lay["iter_bytes"] == 0) == (bb < 128)
    else:
        assert lay["route"] == "compact" and (lay["iter_bytes"] == 0) == (bb < 256)
    assert lay["device"] == device
    before = (qb.btd_step_wide_launches, qb.btd_step_launches)
    step_args = tuple(t[k] for k in ("pd", "pe", "J", "g", "l", "u", "active", "x", "z", "y"))
    ok = qb.btd_step_kernel(*step_args, s, rho_in=t["rho_in"])
    ref = _btd_raw(qb.qp_btd_reference, t, s, active=t["active"], rho_in=t["rho_in"])
    torch.cuda.synchronize()
    assert (qb.btd_step_wide_launches, qb.btd_step_launches) == (before[0] + 1, before[1])
    if nnz is not None:
        # a count the caller carries (as the SOC re-solve does) is the one
        # the launch reads back
        again = qb.btd_step_kernel(*step_args, s, rho_in=t["rho_in"], nnz=nnz)
        assert all(torch.equal(getattr(again, k), getattr(ok, k)) for k in ("x", "iter"))
    a = _to(btd_qp_inputs(batch, T, bb, m, seed=bb + 1), cuda)
    qp = QuadraticProblem(P=a["P"], q=a["q"], A=a["A"], l=a["l"], u=a["u"])
    before = (qb.qp_solve_btd_wide_launches, qb.qp_solve_btd_launches)
    res = qb.qp_solve_kernel_btd(qp, s)
    assert (qb.qp_solve_btd_wide_launches, qb.qp_solve_btd_launches) == (before[0] + 1,
                                                                          before[1])
    pd, pe = qb.extract_band(a["P"], bb)
    zx, zm = torch.zeros_like(a["q"]), torch.zeros_like(a["l"])
    ref6 = qb.qp_btd_reference(pd, pe, a["A"], a["q"], a["l"], a["u"], zx, zm, zm, s,
                               check_infeas=s.check_infeasibility)
    torch.cuda.synchronize()
    agree = []
    for got, want in ((ok, ref), (res, ref6)):
        it = got.iter if hasattr(got, "iter") else got.info.iter
        assert torch.equal(it > 0, want.iter > 0)
        same = it == want.iter
        agree.append(same)
        for name in ("x", "z", "y"):
            torch.testing.assert_close(getattr(got, name)[same], getattr(want, name)[same],
                                       **TOL, msg=lambda msg, name=name: f"{name}: {msg}")
    assert not ok.fail.any() and torch.equal(ok.done, ref.done) and ok.band.all()
    assert torch.equal(ok.x[-1], t["x"][-1]) and int(ok.iter[-1]) == 0
    assert torch.cat(agree).float().mean().item() >= 0.99


@pytest.mark.parametrize("anderson", [False, True], ids=["plain", "anderson"])
def test_btd_wide_step_at_the_nlp_shape_matches_plain_float64(cuda, anderson):
    """The wide K7 at the structured NLP's block-64 shape (n = 128, m = 224,
    B = 64, T = 2; every array an iteration reads on chip, every problem on
    the band route) on random band QPs, one rho epoch, with and without
    Anderson acceleration: the kernel's iteration counts agree with the
    plain version's in float64 on >= 99 % of the problems, its x, z, y lie
    within atol = rtol = 1e-4 of float64's where they agree, and no farther
    from them than twice the plain float32 version's distance (+ 1e-5).
    Held against float64 because with Anderson the plain float32 version
    itself lies ~3e-4 from float64 on a few dual entries here, farther than
    the kernel does."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_step_inputs

    s = dataclasses.replace(BTD_QP, block_size=64)
    if anderson:
        s = dataclasses.replace(s, check_termination=10, acceleration="anderson",
                                anderson_memory=3)
    lay = qb.wide_layout(128, 224, 64)
    assert lay["cluster"] == 2 and lay["iter_bytes"] == 0 and lay["device"] == []
    t = _to(btd_step_inputs(64, 2, 64, 224, seed=64), cuda)
    t64 = {k: (v.double() if v.is_floating_point() else v) for k, v in t.items()}
    ok = qb.btd_step_kernel(*(t[k] for k in ("pd", "pe", "J", "g", "l", "u", "active", "x",
                                             "z", "y")), s, rho_in=t["rho_in"])
    p32 = _btd_raw(qb.qp_btd_reference, t, s, active=t["active"], rho_in=t["rho_in"])
    p64 = _btd_raw(qb.qp_btd_reference, t64, s, active=t["active"], rho_in=t64["rho_in"])
    torch.cuda.synchronize()
    assert ok.band.all() and not ok.fail.any() and torch.equal(ok.done, p64.done)
    same = (ok.iter == p64.iter) & (p32.iter == p64.iter)
    assert same.float().mean().item() >= 0.99
    err = {}
    for who, got in (("kernel", ok), ("plain", p32)):
        err[who] = max(float((getattr(got, k)[same].double() - getattr(p64, k)[same])
                             .abs().max()) for k in ("x", "z", "y"))
    for name in ("x", "z", "y"):
        torch.testing.assert_close(getattr(ok, name)[same].double(), getattr(p64, name)[same],
                                   **TOL, msg=lambda msg, name=name: f"{name}: {msg}")
    assert err["kernel"] <= 2 * err["plain"] + 1e-5, err


def test_btd_wide_kernel_mixed_routes(cuda):
    """A batch in which two problems have a row across three column blocks:
    those take the dense route, the others the band rows, both in the one
    kernel; the routes equal band_rows' and the plain wide route's, the
    wrapper's tally counts them, and both routes match the plain version
    (atol = rtol = 1e-4 where the counts agree, which they do on >= 99 %
    of the problems and on a problem of each route)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_route_inputs

    a = _to(btd_route_inputs(32, 4, 40, 120, seed=4, dense=(3, 17)), cuda)
    pd, pe = qb.extract_band(a["P"], 40)
    s = dataclasses.replace(BTD_QP, block_size=40)
    args = (pd, pe, a["A"], a["q"], a["l"], a["u"], a["x"], a["z"], a["y"], s)
    qb.reset_wide_route_counts()
    ok = qb._qp_btd_launch(*args, None, None, True, "test")
    ref = qb.qp_btd_reference(*args, check_infeas=True, band=True)
    torch.cuda.synchronize()
    want = torch.ones(32, dtype=torch.bool, device=cuda)
    want[[3, 17]] = False
    assert torch.equal(ok.band, want) and torch.equal(ref.band, want)
    assert torch.equal(qb.band_rows(a["A"], 40)[2], want)
    assert qb.wide_route_counts() == dict(band=30, dense=2)
    assert torch.equal(ok.fail, ref.fail) and torch.equal(ok.infs, ref.infs)
    same = ok.iter == ref.iter
    assert same.float().mean().item() >= 0.99 and bool(same[~want].any())
    for name in ("x", "z", "y"):
        torch.testing.assert_close(getattr(ok, name)[same], getattr(ref, name)[same], **TOL,
                                   msg=lambda msg, name=name: f"{name}: {msg}")


def test_btd_past128_kernel_mixed_routes(cuda):
    """Past internal block 128 (the compact route, bb = 136, T = 3): a batch
    in which two problems have a row across three column blocks takes the
    dense route for those (their rows read where the problem gives them)
    and the compact rows for the others, in one launch; the routes equal
    band_rows' and the plain wide route's, and both routes match the plain
    version (atol = rtol = 1e-4 where the counts agree, on >= 99 % of the
    problems and on a problem of each route)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_route_inputs

    a = _to(btd_route_inputs(16, 3, 136, 60, seed=6, dense=(2, 11)), cuda)
    pd, pe = qb.extract_band(a["P"], 136)
    s = dataclasses.replace(BTD_QP, block_size=136)
    args = (pd, pe, a["A"], a["q"], a["l"], a["u"], a["x"], a["z"], a["y"], s)
    lay = qb.wide_layout(408, 60, 136, nnz=qb.compact_nnz(a["A"], 136))
    assert lay["route"] == "compact"
    qb.reset_wide_route_counts()
    ok = qb._qp_btd_launch(*args, None, None, True, "test")
    ref = qb.qp_btd_reference(*args, check_infeas=True, band=True)
    torch.cuda.synchronize()
    want = torch.ones(16, dtype=torch.bool, device=cuda)
    want[[2, 11]] = False
    assert torch.equal(ok.band, want) and torch.equal(ref.band, want)
    assert qb.wide_route_counts() == dict(band=14, dense=2)
    assert torch.equal(ok.fail, ref.fail) and torch.equal(ok.infs, ref.infs)
    same = ok.iter == ref.iter
    assert same.float().mean().item() >= 0.99 and bool(same[~want].any())
    for name in ("x", "z", "y"):
        torch.testing.assert_close(getattr(ok, name)[same], getattr(ref, name)[same], **TOL,
                                   msg=lambda msg, name=name: f"{name}: {msg}")


def test_btd_wide_layout_keeps_iterations_on_chip(cuda):
    """The rule's layouts: at the 6-DOF arm's shape (n = 360, m = 600,
    internal block 40; K7's timed shape too) a cluster of two blocks holds
    L^-1, the couplings and A's band rows, so an ADMM iteration reads
    nothing from device memory; so does the structured NLP's block-64
    shape; at bb = 128, T = 2, where two blocks cannot hold A's band rows
    beside L^-1 and the couplings, the band rows take shared memory first;
    the launcher refuses any other cluster than two, and a shape whose
    vectors fit no block."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_step_inputs

    for n, m, bb in ((360, 600, 40), (128, 224, 64), (256, 384, 64)):
        lay = qb.wide_layout(n, m, bb)
        assert lay["cluster"] == 2 and lay["iter_bytes"] == 0, (n, m, bb, lay)
        assert {"Li", "GH", "A"} <= set(lay["shared"]) and lay["smem_bytes"] <= 232448
        assert lay["rows_per_member"] == -(-m // 2) and lay["band_width"] == 2 * bb
    lay = qb.wide_layout(256, 256, 128)
    assert lay["cluster"] == 2 == qb.cluster_size(256, 256, 128, 128)
    assert "A" in lay["shared"] and "GH" in lay["device"] and lay["iter_bytes"] > 0
    assert qb.wide_layout(8192, 64, 128) is None
    assert qb.cluster_size(8192, 64, 128, 8) == 0
    t = _to(btd_step_inputs(2, 3, 40, 30, seed=0), cuda)
    with pytest.raises(ValueError, match="cluster of 2"):
        qb._qp_btd_launch(*(t[k] for k in ("pd", "pe", "J", "g", "l", "u", "x", "z", "y")),
                          BTD_QP, t["active"], t["rho_in"], False, "test", cluster=4)


def test_btd_wide_kernel_on_the_control_arm_matches_plain_float64(cuda):
    """The OSQP control class's 6-DOF arm (declared block 18, internal
    block 40, n = 360, m = 600: 240 dynamics equalities) through
    ``qp_solve_batch(impl="kernel")`` on the card at OSQP's 1e-3 bars:
    every problem solved, as by the plain version in float32; two float32
    runs that stop at the same iteration may lie ~1e-3 apart at these bars,
    so the kernel's largest distance from the float64 plain version's x
    must stay within twice the plain float32 version's (plus 1e-5)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.testing import control_qp_inputs

    a = control_qp_inputs(16, seed=3)
    s = QPSettings(alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, max_iter=8000, check_termination=25,
                   adaptive_rho=True, adaptive_rho_interval=50, rho=1.0, schedule="fixed",
                   linear_solver="schur_block_tridiag", block_size=18)
    t = _to(a, cuda)
    qp = QuadraticProblem(P=t["P"], q=t["q"], A=t["A"], l=t["l"], u=t["u"])
    before = qb.qp_solve_btd_wide_launches
    res = qp_solve_batch(qp, s, impl="kernel")
    torch.cuda.synchronize()
    assert qb.qp_solve_btd_wide_launches == before + 1
    leaves = [v.cpu() for v in (qp.P, qp.q, qp.A, qp.l, qp.u)]
    ref = qp_solve_batch(QuadraticProblem(*(v.double() for v in leaves)), s, impl="kernel")
    plain = qp_solve_batch(QuadraticProblem(*leaves), s, impl="kernel")
    err = {}
    for name, out in (("kernel", res), ("plain", plain)):
        assert (out.info.status.cpu() == QPStatus.SOLVED).all(), name
        err[name] = (out.x.cpu().double() - ref.x).abs().max().item()
    assert (ref.info.status == QPStatus.SOLVED).all()
    assert err["kernel"] <= 2 * err["plain"] + 1e-5, err


def test_btd_wide_kernel_on_the_control_class_at_50_states(cuda):
    """The OSQP control class at 50 states and 25 inputs over 10 steps
    (declared stage block 75, internal block 152, n = 750 padded to 760,
    m = 1,250), which the card refused before the wide kernel took
    internal blocks past 128: ``qp_solve_batch(impl="kernel")`` launches
    the wide K6 once, every problem on the band rows, and solves every
    problem, as the plain version in float32 does (on the card); where the
    plain float64 version solved too, the kernel's x lies no farther from
    its x than twice the plain float32 version's (plus 1e-5).  The K7
    entry at this shape takes the same kernel, one launch."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.testing import control_qp_inputs

    a = control_qp_inputs(8, horizon=10, nx=50, nu=25, seed=5)
    s = QPSettings(alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, max_iter=8000, check_termination=25,
                   adaptive_rho=True, adaptive_rho_interval=50, rho=1.0, schedule="fixed",
                   linear_solver="schur_block_tridiag", block_size=75)
    assert qb.btd_internal_block(75) == 152
    t = _to(a, cuda)
    qp = QuadraticProblem(P=t["P"], q=t["q"], A=t["A"], l=t["l"], u=t["u"])
    before = qb.qp_solve_btd_wide_launches
    qb.reset_wide_route_counts()
    res = qp_solve_batch(qp, s, impl="kernel")
    torch.cuda.synchronize()
    assert qb.qp_solve_btd_wide_launches == before + 1
    assert qb.wide_route_counts() == dict(band=8, dense=0)
    assert res.x.shape == (8, 750) and bool(torch.isfinite(res.x).all())
    assert (res.info.status == QPStatus.SOLVED).all()
    # the padded operands as qp_solve_kernel_btd builds them
    P = torch.nn.functional.pad(t["P"], (0, 10, 0, 10))
    P[:, 750:, 750:] = torch.eye(10, device=cuda)
    pd, pe = qb.extract_band(P, 152)
    J = torch.nn.functional.pad(t["A"], (0, 10)).contiguous()
    g = torch.nn.functional.pad(t["q"], (0, 10)).contiguous()
    zx, zm = torch.zeros((8, 760), device=cuda), torch.zeros((8, 1250), device=cuda)
    ops = dict(pd=pd, pe=pe, J=J, g=g, l=t["l"], u=t["u"], x=zx, z=zm, y=zm)
    p32 = _btd_raw(qb.qp_btd_reference, ops, s, check_infeas=True)
    p64 = _btd_raw(qb.qp_btd_reference, {k: v.double() for k, v in ops.items()}, s,
                   check_infeas=True)
    torch.cuda.synchronize()
    assert (p32.done & ~p32.fail).all()
    both = p64.done & ~p64.fail
    err = {name: (x[both].double() - p64.x[both, :750]).abs().max().item()
           for name, x in (("kernel", res.x), ("plain", p32.x[:, :750]))}
    assert err["kernel"] <= 2 * err["plain"] + 1e-5, err
    before = qb.btd_step_wide_launches
    out = qb.btd_step_kernel(pd, pe, J, g, t["l"], t["u"],
                             torch.ones(8, dtype=torch.bool, device=cuda), zx, zm, zm,
                             dataclasses.replace(s, max_iter=200))
    torch.cuda.synchronize()
    assert qb.btd_step_wide_launches == before + 1
    assert bool(torch.isfinite(out.x).all()) and out.band.all() and not out.fail.any()


_LEG_P = {}


def _leg_p(cuda):
    """Leg P's constraint matrix (the control class at 50 states, B = 128,
    padded to n = 760) and its nonzeros a block holds (``compact_nnz``)."""
    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    if "A" not in _LEG_P:
        ops, _ = cs.control50_operands(cs.control50_qp(128, 50, cuda), 152, cuda)
        _LEG_P.update(A=ops["J"], nnz=qb.compact_nnz(ops["J"], 152))
    return _LEG_P["A"], _LEG_P["nnz"]


def _layout_cases(cuda):
    """(label, n, m, internal block, A) at every shape of
    ``chip_smoke.btd_wide_cases`` and ``btd_past128_cases`` and at leg P's."""
    import chip_smoke as cs

    out = [(c["label"], c["n"], c["m"], c["bb"], c["t"]["J"])
           for c in cs.btd_wide_cases(cuda) + cs.btd_past128_cases(cuda)]
    return out + [("leg P", 760, 1250, 152, _leg_p(cuda)[0])]


def test_wide_layout_rule_on_the_card(cuda):
    """The layout the C entry reports (qp_btd_wide_layout_nnz, through
    ``wide_layout``) at every shape of chip_smoke.py's wide and past-128
    cases and at leg P's, without Anderson and at memories 4 and 40 (the
    Gram area on chip at 4, and at 40 only beside the same arrays): up to
    internal block 128 a cluster of two and the band route, whatever the
    nonzeros; past it the compact route in a cluster of 2, 4 or 8 that
    reads no more from device memory than the band rows' full count would,
    and holds A on chip where it reads nothing else; at leg P's shape a
    cluster of eight, every coupling of the sweeps in shared memory and at
    most 0.5 MB an iteration from device memory (4.24 MB on the band
    route)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    for label, n, m, bb, A in _layout_cases(cuda):
        nnz = qb.compact_nnz(A, bb) if bb > qb.COMPACT_ABOVE else None
        card = qb.wide_layout(n, m, bb, nnz=nnz)
        for k in (4, 40):
            aa = qb.wide_layout(n, m, bb, nnz=nnz, anderson=k)
            assert aa["cluster"] == card["cluster"] and (aa["gram_shared"] or k > 32), label
            if aa["gram_shared"] and k > 32:
                assert aa["shared"] == card["shared"], (label, k, aa)
        if bb <= qb.COMPACT_ABOVE:
            assert card["cluster"] == 2 and card["route"] == "band", label
            assert card == qb.wide_layout(n, m, bb, nnz=(1, 1, 1)), label
            continue
        full = qb.wide_layout(n, m, bb)
        assert card["route"] == "compact" and card["cluster"] in qb.COMPACT_CLUSTERS, label
        assert card["iter_bytes"] <= full["iter_bytes"], (label, card, full)
        assert card["nnz"] == nnz[qb.COMPACT_CLUSTERS.index(card["cluster"])], label
        if card["iter_bytes"] == 0:
            assert "A" in card["shared"], label
    assert card["cluster"] == 8 and card["iter_bytes"] <= 500_000, card
    assert {f"G{k}" for k in range(1, 5)} | {f"H{k}" for k in range(4)} <= set(card["shared"])


# (batch, T, internal block, m) past 128: the compact route's cluster of
# four (bb = 136, T = 2: every matrix on chip), eight (bb = 152; bb = 256,
# where a matrix outgrows a block's shared memory)
PAST128_SHAPES = [pytest.param(16, 2, 136, 160, id="bb136"),
                  pytest.param(16, 2, 152, 150, id="bb152"),
                  pytest.param(8, 2, 256, 200, id="bb256")]


@pytest.mark.parametrize("memory", [0, 4, 40], ids=["none", "aa4", "aa40"])
@pytest.mark.parametrize("entry", ["K6", "K7"])
@pytest.mark.parametrize("batch,T,bb,m", PAST128_SHAPES)
def test_btd_past128_kernels_match_plain_float32_and_float64(cuda, batch, T, bb, m, entry,
                                                              memory):
    """The compact route past internal block 128 on random band QPs
    without equality rows, one rho epoch (K6 cold with certificates; K7
    with a carried rho on every second problem and the last inactive),
    without Anderson and with memories 4 and 40 (chunks of 10): every
    problem on the band route; each float32 code held against the plain
    float64 version as ``chip_smoke.against_f64`` holds them (a float32
    code stops at another chunk than float64 on a problem near the bar now
    and then, and the plain version on the card sums with atomics, so its
    own counts vary from run to run): the kernel matching float64's
    iteration and rho-update counts on at least ``BTD_AGREE`` of the plain
    float32 version's share, its x, z, y within ``EPOCH_TOL`` of float64's
    where it does, within atol = rtol = 1e-4 of the plain float32
    version's where both do, and there no farther from float64 than twice
    the plain float32 version (+ 1e-5)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_qp_inputs, btd_step_inputs

    s = dataclasses.replace(BTD_QP, block_size=bb)
    if memory:
        s = dataclasses.replace(s, check_termination=10, acceleration="anderson",
                                anderson_memory=memory)
    if entry == "K7":
        t = _to(btd_step_inputs(batch, T, bb, m, seed=bb), cuda)
        kw = dict(active=t["active"], rho_in=t["rho_in"])
        ci = False
    else:
        a = _to(btd_qp_inputs(batch, T, bb, m, seed=bb + 2), cuda)
        pd, pe = qb.extract_band(a["P"], bb)
        zx, zm = torch.zeros_like(a["q"]), torch.zeros_like(a["l"])
        t = dict(pd=pd, pe=pe, J=a["A"], g=a["q"], l=a["l"], u=a["u"], x=zx, z=zm, y=zm)
        kw = dict(active=None, rho_in=None)
        ci = True
    t64 = {k: (v.double() if v.is_floating_point() else v) for k, v in t.items()}
    ok = _btd_raw(qb._qp_btd_launch, t, s, check_infeas=ci, name="test", **kw)
    k64 = {k: (v.double() if v is not None and v.is_floating_point() else v)
           for k, v in kw.items()}
    p32 = _btd_raw(qb.qp_btd_reference, t, s, check_infeas=ci, band=True, **kw)
    p64 = _btd_raw(qb.qp_btd_reference, t64, s, check_infeas=ci, band=True, **k64)
    torch.cuda.synchronize()
    import chip_smoke as cs

    assert ok.band.all() and not ok.fail.any() and torch.equal(ok.infs, p32.infs)
    agree = {who: (got.iter == p64.iter) & (got.rho_updates == p64.rho_updates)
             for who, got in (("kernel", ok), ("plain", p32))}
    share = {who: a.float().mean().item() for who, a in agree.items()}
    assert share["kernel"] >= cs.BTD_AGREE * share["plain"], share
    both = agree["kernel"] & agree["plain"]
    for name in ("x", "z", "y"):
        got, want = getattr(ok, name), getattr(p64, name)
        torch.testing.assert_close(got[agree["kernel"]].double(), want[agree["kernel"]],
                                   atol=cs.EPOCH_TOL, rtol=cs.EPOCH_TOL,
                                   msg=lambda msg, name=name: f"{name} against f64: {msg}")
        torch.testing.assert_close(got[both], getattr(p32, name)[both], **TOL,
                                   msg=lambda msg, name=name: f"{name}: {msg}")
    err = {who: max(float((getattr(got, k)[both].double() - getattr(p64, k)[both]).abs().max())
                    for k in ("x", "z", "y")) for who, got in (("kernel", ok), ("plain", p32))}
    assert err["kernel"] <= 2 * err["plain"] + 1e-5, err


def test_structured_paths_on_cuda_match_cpu_plain(cuda):
    """The stage-wise MPC QP through K6 and the unicycle NLP through the
    structured SQP tier (K7), on the card against the plain versions on the
    CPU: statuses agree on >= 90 % and SOLVED x within 1e-3 (float32
    trajectories of a family with equality rows part, ROADMAP Queue 3)."""
    import dataclasses

    from sqp_solver_tpu_torch.models.mpc import mpc_nlp_stagewise_batch, mpc_qp_stagewise_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    s = QPSettings(adaptive_rho=True, max_iter=100, schedule="fixed",
                   linear_solver="schur_block_tridiag", block_size=3)
    out = {}
    for dev in ("cpu", cuda):
        qp, _ = mpc_qp_stagewise_batch(64, horizon=16, device=dev)
        out[str(dev)] = qp_solve_batch(qp, s, impl="kernel")
    a, b = out["cpu"], out["cuda"]
    agree = (a.info.status == b.info.status.cpu())
    assert agree.float().mean().item() >= 0.9
    both = agree & (a.info.status == 0)
    torch.testing.assert_close(b.x.cpu()[both], a.x[both], atol=1e-3, rtol=1e-3)
    settings = SQPSettings(max_iter=20, eps_prim=1e-4, eps_dual=1e-4, termination="kkt",
                           schedule="fixed", qp_impl="kernel_btd", polish=True,
                           qp=dataclasses.replace(SQPSettings().qp, block_size=4))
    res = {}
    for dev in ("cpu", cuda):
        prob, x0, _ = mpc_nlp_stagewise_batch(8, horizon=8, seed=1, device=dev)
        res[str(dev)] = sqp_solve_batch(prob, x0, None, settings, impl="fused")
    assert res["cuda"].x.shape == (8, 32) and torch.isfinite(res["cuda"].x).all()


# ---------------------------------------------------------------------------
# the reference-semantics tier (impl="vmap") and Ruiz scaling
# ---------------------------------------------------------------------------

VMAP_QP = dict(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=400, check_termination=25)
VMAP_CASES = {
    "rho_epochs": dict(adaptive_rho=True, adaptive_rho_interval=25, max_iter=300),
    "infeasible": dict(max_iter=200),
    "anderson": dict(acceleration="anderson", anderson_memory=3),
    "equality_row": dict(adaptive_rho=True, adaptive_rho_interval=50),
}
# the families leg's settings (bench.py:1061-1065)
FAMILY_QP = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=300,
                       check_termination=25, adaptive_rho=True, adaptive_rho_interval=50,
                       polish=True, scaling=10, schedule="fixed")


def _counts():
    from sqp_solver_tpu_torch.ops import admm_kernel as ak

    return (qk.sqp_step_launches, qk.polish_kkt_launches, qk.qp_solve_launches,
            ak.admm_chunk_launches)


def _launched(before):
    return tuple(b - a for a, b in zip(before, _counts()))


@pytest.mark.parametrize("case", list(VMAP_CASES))
def test_vmap_qp_tier_on_cuda_float64_matches_cpu(cuda, case):
    """qp_solve_batch(impl="vmap") on CUDA float64 tensors against the same
    tier on the CPU: statuses, iteration and rho-update counts equal, x
    within 1e-9 (plus 1e-9 relative on infeasible problems, whose iterates
    run off); unpolished, it launches no kernel."""
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    if case == "infeasible":
        a = certificate_qp_inputs(24, 6, seed=4)
    else:
        a = qp_inputs(32, 8, 10, seed=3, equality_row=case == "equality_row", loose_row=True)
    s = QPSettings(**dict(VMAP_QP, **VMAP_CASES[case]))
    res = {}
    for dev in ("cpu", cuda):
        qp = QuadraticProblem(*(torch.as_tensor(a[k], dtype=torch.float64).to(dev)
                                for k in LEAVES))
        before = _counts()
        res[str(dev)] = qp_solve_batch(qp, s)
        assert _launched(before) == (0, 0, 0, 0)
    a_, b_ = res["cpu"], res["cuda"]
    for k in ("status", "iter", "rho_updates"):
        assert torch.equal(getattr(a_.info, k), getattr(b_.info, k).cpu()), k
    rtol = 1e-9 if case == "infeasible" else 0.0
    for k in ("x", "y", "z"):
        torch.testing.assert_close(getattr(b_, k).cpu(), getattr(a_, k), atol=1e-9, rtol=rtol)
    assert bool((a_.info.status == QPStatus.SOLVED).any())


def test_vmap_sqp_tier_on_cuda_float64_matches_cpu(cuda):
    """sqp_solve_batch(impl="vmap") on the sphere cap, B = 16, n = 8, with
    and without SOC, CUDA float64 against the CPU: statuses and outer
    iteration counts equal; the accumulated QP iterations equal on >= 90 %
    of problems (a matvec summed in another order can move one QP's
    termination by a chunk: 560 against 570 on one problem of 16 on an
    H100); x and lambda within 1e-8 where those agree and the problem
    SOLVED (a problem stalled at max_iter wanders: 2.5e-5 apart there)."""
    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    for soc in (False, True):
        s = SQPSettings(max_iter=20, termination="kkt", eps_prim=1e-6, eps_dual=1e-6,
                        second_order_correction=soc)
        res = {}
        for dev in ("cpu", cuda):
            prob, x0 = sphere_cap_nlp_batch(16, 8, seed=2, dtype=torch.float64, device=dev)
            res[str(dev)] = sqp_solve_batch(prob, x0, None, s)
        a, b = res["cpu"], res["cuda"]
        for k in ("status", "iter"):
            assert torch.equal(getattr(a.info, k), getattr(b.info, k).cpu()), (soc, k)
        same = a.info.qp_solver_iter == b.info.qp_solver_iter.cpu()
        assert same.float().mean().item() >= 0.9
        keep = same & (a.info.status == 0)
        assert int(keep.sum()) >= 3
        torch.testing.assert_close(b.x.cpu()[keep], a.x[keep], atol=1e-8, rtol=0)
        torch.testing.assert_close(b.lam.cpu()[keep], a.lam[keep], atol=1e-8, rtol=0)


@pytest.mark.parametrize("impl", ["vmap", "kernel", "fused"])
def test_scaled_qp_paths_on_cuda_match_cpu_plain(cuda, impl):
    """The huber family under scaling 10 and polish through each QP tier,
    on the card (K3 or K5, then K2) against the plain versions on the CPU,
    float32, with the comp-slack term scored at the unscaled rescore (on
    this degenerate family it demotes points whose y sits on interior
    rows, which rp and rd alone call SOLVED: without it x differed there
    by up to 2.6 between the two runs on an H100): statuses agree on
    >= 95 %, x within 1e-3 where both solved."""
    from sqp_solver_tpu_torch.models.families import huber_qp_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    settings = dataclasses.replace(FAMILY_QP, check_comp_slack=True)
    res = {}
    for dev in ("cpu", cuda):
        qp, _ = huber_qp_batch(128, 8, 16, seed=2, device=dev)
        before = _counts()
        res[str(dev)] = qp_solve_batch(qp, settings, impl=impl)
        want = {"vmap": (0, 2, 0, 0), "kernel": (0, 2, 1, 0), "fused": (0, 2, 0, 12)}[impl]
        assert _launched(before) == ((0, 0, 0, 0) if dev == "cpu" else want)
    a, b = res["cpu"], res["cuda"]
    agree = a.info.status == b.info.status.cpu()
    assert agree.float().mean().item() >= 0.95
    both = agree & (a.info.status == 0)
    assert both.float().mean().item() >= 0.9
    torch.testing.assert_close(b.x.cpu()[both], a.x[both], atol=1e-3, rtol=1e-3)


def test_scaled_kernel_sqp_tier_on_cuda_matches_cpu_plain(cuda):
    """The K1 tier under qp.scaling = 10 (BFGS outside the kernel, K1 with
    do_bfgs=False, SOC reusing the first solve's factors): 3 outer
    iterations and their SOC re-solves launch K1 six times, polish K2
    twice; the card against the plain path on the CPU."""
    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    settings = SQPSettings(max_iter=3, eps_prim=2e-3, eps_dual=2e-3, termination="kkt",
                           schedule="fixed", qp_impl="kernel", polish=True, polish_passes=2,
                           line_search_max_iter=5, second_order_correction=True,
                           qp=dataclasses.replace(MAIN_QP, scaling=10))
    res = {}
    for dev in ("cpu", cuda):
        prob, x0 = sphere_cap_nlp_batch(64, 16, seed=4, dtype=torch.float32, device=dev)
        before = _counts()
        res[str(dev)] = sqp_solve_batch(prob, x0, None, settings, impl="fused")
        assert _launched(before) == ((0, 0, 0, 0) if dev == "cpu" else (6, 2, 0, 0))
    a, b = res["cpu"], res["cuda"]
    agree = a.info.status == b.info.status.cpu()
    assert agree.float().mean().item() >= 0.95
    both = agree & (a.info.status == 0)
    # the unconditional SOC stalls some sphere-cap problems (quirk Q6):
    # 0.36 of them solve in three outer iterations on the CPU
    assert both.float().mean().item() >= 0.25
    np.testing.assert_allclose(b.x.cpu()[both].numpy(), a.x[both].numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# Anderson acceleration inside the whole-solve kernels (K1, K3, K6, K7), and
# the linear-solver backends
# ---------------------------------------------------------------------------

# rho epochs with Anderson at a tolerance that leaves it pairs to work with
AA_QP = QPSettings(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=300, check_termination=25,
                   adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
                   acceleration="anderson")
AA_KINDS = ["K1", "K3-block", "K3-warp", "K6-cluster", "K6-block", "K7"]
# the structured kinds past memory 32: the narrow K6 and K7, the wide
# kernel's band route (K6, K7 at internal block 40) and its compact route
# (K6 at 136)
AA_STRUCTURED = ["K6-cluster", "K6-block", "K7", "K6-wide", "K7-wide", "K6-compact"]
# (n, m, internal block) of the wide kinds
AA_WIDE_SHAPES = {"K6-wide": (80, 60, 40), "K7-wide": (80, 60, 40), "K6-compact": (272, 128, 136)}


def _aa_case(kind, memory, cuda, seg=None, acceleration="anderson", rho_every=None, eps=None,
             batch=None, lib=None, alpha=None):
    """(float32 inputs, kernel launch, plain call) of one kind: each call
    takes the inputs and returns an object with x (or p), z, y, iter,
    rho_updates and done.  ``seg`` replaces the chunk length, ``rho_every``
    the rho interval (50 iterations, 40 for K1), ``eps`` the tolerances
    (1e-5), ``batch`` the problems (128, 64 for K6/K7) and ``alpha`` the
    relaxation (1.6); ``lib`` a kernel library (the package's by default).  The wide kinds (AA_WIDE_SHAPES)
    run random band QPs at T = 2 (K7's with a carried rho on every second
    problem and the last inactive)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_qp_inputs, btd_step_inputs

    s = dataclasses.replace(AA_QP, anderson_memory=memory, acceleration=acceleration)
    if seg is not None:
        s = dataclasses.replace(s, check_termination=seg)
    if rho_every is not None:
        s = dataclasses.replace(s, adaptive_rho_interval=rho_every)
    if eps is not None:
        s = dataclasses.replace(s, eps_abs=eps, eps_rel=eps)
    if alpha is not None:
        s = dataclasses.replace(s, alpha=alpha)
    if kind == "K1":
        s = dataclasses.replace(s, check_termination=seg or 10,
                                adaptive_rho_interval=rho_every or 40)
        t = _to(step_inputs(batch or 128, 16, 17, seed=31, equality_row=False), cuda)
        return (t, lambda t: _step(qk._sqp_step_launch, t, s, lib=lib),
                lambda t: _step(qk.sqp_step_reference, t, s))
    if kind.startswith("K3"):
        n, m = (40, 41) if kind == "K3-block" else (16, 24)
        t = _to(qp_inputs(batch or 128, n, m, seed=n + m, loose_row=True), cuda)
        layout = kind.split("-")[1]
        assert (qk.qp_solve_problems_per_block(n, m) > 1) == (layout == "warp")
        return (t, lambda t: _qp_raw(lambda *a: qk._qp_solve_launch(*a, layout=layout, lib=lib),
                                     t, s),
                lambda t: _qp_raw(qk.qp_solve_reference, t, s))
    n, m, bb = AA_WIDE_SHAPES.get(kind, (32, 24, 8))
    bs = dataclasses.replace(s, linear_solver="schur_block_tridiag", block_size=bb)
    if kind.startswith("K6"):
        a = btd_qp_inputs(batch or 64, n // bb, bb, m, seed=41 + bb - 8, loose_row=True)
        pd, pe = qb.extract_band(torch.as_tensor(a["P"]), bb)
        t = _to(dict(pd=pd.numpy(), pe=pe.numpy(), J=a["A"], g=a["q"], l=a["l"], u=a["u"],
                     x=a["x"], z=a["z"], y=a["y"]), cuda)
        cluster = {"K6-cluster": 2, "K6-block": 1}.get(kind)
        assert kind != "K6-cluster" or qb.cluster_size(32, 24, 8, 64) == 2
        return (t, lambda t: _btd_raw(qb._qp_btd_launch, t, bs, active=None, rho_in=None,
                                      check_infeas=True, name="test", cluster=cluster, lib=lib),
                lambda t: _btd_raw(qb.qp_btd_reference, t, bs, check_infeas=True))
    t = _to(btd_step_inputs(batch or 64, n // bb, bb, m, seed=43 + bb - 8), cuda)
    if lib is not None:  # the entry takes the package's library
        return (t, lambda t: _btd_raw(qb._qp_btd_launch, t, bs, active=t["active"],
                                      rho_in=t["rho_in"], check_infeas=False, name="test",
                                      lib=lib),
                lambda t: _btd_raw(qb.qp_btd_reference, t, bs, active=t["active"],
                                   rho_in=t["rho_in"]))
    return (t, lambda t: qb.btd_step_kernel(t["pd"], t["pe"], t["J"], t["g"], t["l"], t["u"],
                                            t["active"], t["x"], t["z"], t["y"], bs,
                                            rho_in=t["rho_in"]),
            lambda t: _btd_raw(qb.qp_btd_reference, t, bs, active=t["active"],
                               rho_in=t["rho_in"]))


@pytest.mark.parametrize("memory", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", AA_KINDS)
def test_anderson_kernels_match_plain_float64(cuda, kind, memory):
    """Each kernel with Anderson (K3 in both layouts, K6 on a cluster of two
    blocks and on one) and its plain version with Anderson in float32, each
    against the plain version in float64, under the float32 bars of ROADMAP
    Queue 3: iterates at 5e-4 where the iteration and rho-update counts
    agree and float64 converged, counts agreeing on >= 0.9 of what the
    plain float32 version agrees on."""
    _aa_against_plain_float64(kind, *_aa_case(kind, memory, cuda))


def _aa_against_plain_float64(kind, t32, launch, plain):
    """The bars of test_anderson_kernels_match_plain_float64; the kernel's
    output."""
    t64 = {k: v.double() if v.dtype == torch.float32 else v for k, v in t32.items()}
    ok, p32, p64 = launch(t32), plain(t32), plain(t64)
    torch.cuda.synchronize()
    assert p64.done.float().mean() >= 0.5
    x = "p" if kind == "K1" else "x"
    agree = {}
    for label, out in (("kernel", ok), ("plain", p32)):
        same = (out.iter == p64.iter) & (out.rho_updates == p64.rho_updates)
        agree[label] = same.float().mean().item()
        cmp = same & p64.done
        for name in (x, "z", "y"):
            torch.testing.assert_close(getattr(out, name)[cmp].double(),
                                       getattr(p64, name)[cmp], atol=5e-4, rtol=5e-4)
    assert agree["kernel"] >= 0.9 * agree["plain"], agree
    return ok


@pytest.mark.parametrize("kind", AA_KINDS)
def test_anderson_kernels_with_several_pairs(cuda, kind):
    """As test_anderson_kernels_match_plain_float64 at memory 4, with chunks
    of 10 iterations: four or five chunks an epoch, so that the ring holds
    several pairs (at chunks of 25 and rho every 50 a rho change empties it
    every second chunk).  The step must have done work: iteration counts
    that differ from the launch without Anderson on some problems, and a
    quarter of the problems or more through three chunks, whose third (in
    the first epoch, before any reset) solves a Gram of two pairs."""
    ok = _aa_against_plain_float64(kind, *_aa_case(kind, 4, cuda, seg=10))
    t32, launch_none, _ = _aa_case(kind, 4, cuda, seg=10, acceleration="none")
    none = launch_none(t32)
    assert (ok.iter != none.iter).any()
    assert (ok.iter >= 30).float().mean() >= 0.25


@pytest.mark.parametrize("kind", AA_KINDS)
def test_anderson_kernels_ring_wraps_and_rho_resets(cuda, kind):
    """Memory 2 with chunks of 5 iterations and rho every 50 (40 for K1):
    an epoch's ten (eight) chunks push nine (seven) pairs into a ring of
    two slots, which wraps three times or more, and a rho change in
    mid-solve empties the ring and the kept Gram.  The kernel holds to
    plain float64 under the bars of test_anderson_kernels_match_plain_float64;
    some problems change rho in mid-solve and a quarter or more run a whole
    epoch."""
    ok = _aa_against_plain_float64(kind, *_aa_case(kind, 2, cuda, seg=5))
    assert (ok.rho_updates >= 2).any()  # the setup's update counts one
    epoch = 40 if kind == "K1" else 50
    assert (ok.iter >= epoch).float().mean() >= 0.25


@pytest.mark.parametrize("kind", AA_KINDS)
def test_anderson_kernels_refuse_memory_past_the_bound(cuda, kind):
    """The kernels take any memory >= 1 (the bound of 32 an on-chip Gram
    set before the Gram area could leave shared memory is gone): memory 0
    raises a ValueError before any launch; memories 33 and 40 run, with
    finite iterates, as the plain version runs them."""
    t32, launch, plain = _aa_case(kind, 4, cuda)
    t0 = _aa_case(kind, 0, cuda)[1]
    before = _counts()
    with pytest.raises(ValueError, match="anderson_memory"):
        t0(t32)
    assert _launched(before) == (0, 0, 0, 0)
    for memory in (33, 40):
        t32, launch, plain = _aa_case(kind, memory, cuda)
        out = launch(t32)
        x = out.p if kind == "K1" else out.x
        assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(out.y).all())
        assert plain(t32).iter.numel() == t32["l"].shape[0]


@pytest.mark.parametrize("memory", [33, 40])
@pytest.mark.parametrize("kind", AA_KINDS + AA_STRUCTURED[3:])
def test_anderson_kernels_past_memory_32_match_plain_float64(cuda, kind, memory):
    """Memories 33 and 40 with chunks of 2 iterations, rho every 120 and eps
    1e-6: an epoch's 60 chunks push 59 pairs into the ring, which fills
    and wraps before a rho change empties it.  The kernel holds to plain
    float64 under the bars of test_anderson_kernels_match_plain_float64, a
    quarter or more of the problems running past the chunk at which the
    ring wraps.  4096 problems: with a check every 2 iterations a quarter
    or fewer of the float32 runs stop at float64's iteration, so the shares
    that do are estimates, whose spread at 128 or 512 problems passes a
    tenth of them.  The structured kinds run where their launcher puts
    the chunk's system past 32 (a solve area on chip or the workspace:
    ops/qp_kernel.py:anderson_placement), the wide kinds too."""
    ok = _aa_against_plain_float64(kind, *_aa_case(kind, memory, cuda, seg=2, rho_every=120,
                                                   eps=1e-6, batch=4096))
    assert (ok.iter >= 2 * (memory + 2)).float().mean() >= 0.25


@pytest.mark.parametrize("kind", AA_STRUCTURED)
def test_anderson_structured_at_memory_65_match_plain_float64(cuda, kind):
    """K6 (on a cluster and on one block), K7 and the wide kernel's two
    routes at memory 65, where the k x k solve's system passes 64 rows, in
    chunks of 2 with rho every 154, eps 1e-6 and no over-relaxation (alpha
    1; at 1.6 K7's problems stop before the wrap, 0.215 of them past it,
    and at eps below 1e-6 float32 stops agreeing with float64 on its
    counts), so that the ring fills and wraps (at 134 iterations) before a
    rho change empties it: the kernel holds to plain float64 under the bars
    of test_anderson_kernels_match_plain_float64, a quarter or more of the
    problems running past the wrap."""
    ok = _aa_against_plain_float64(kind, *_aa_case(kind, 65, cuda, seg=2, rho_every=154,
                                                   eps=1e-6, batch=4096, alpha=1.0))
    assert (ok.iter >= 2 * (65 + 2)).float().mean() >= 0.25


@pytest.mark.parametrize("kind", ["K1", "K3-block", "K3-warp"])
def test_anderson_k1_k3_at_memory_65_match_plain_float64(cuda, kind):
    """K1 and K3 in each layout at memory 65, where the k x k solve takes
    three rounds of 32 rows, in chunks of 2 with rho every 154 and eps 1e-6,
    so that the ring fills and wraps (at 134 iterations) before a rho change
    empties it: the kernel holds to plain float64 under the bars of
    test_anderson_kernels_match_plain_float64, a quarter or more of the
    problems running past the wrap.  Past 32, K1 and K3 put the chunk's
    system where ops/qp_kernel.py:anderson_placement says (at these shapes a
    solve area a problem or a block; the workspace one is forced in
    test_anderson_forced_placements_are_the_rules_bit_for_bit)."""
    ok = _aa_against_plain_float64(kind, *_aa_case(kind, 65, cuda, seg=2, rho_every=154,
                                                   eps=1e-6, batch=4096))
    assert (ok.iter >= 2 * (65 + 2)).float().mean() >= 0.25


@pytest.fixture(scope="module")
def forced_aa_libs():
    """This checkout's Anderson unit built with each placement of K1's and
    K3's chunk system past memory 32 forced (tools/kernel_ab.py:
    forced_library, -DAA_FORCE_SOLVE=p), all nvcc processes at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with --noconftest -m gpu")
    from sqp_solver_tpu_torch.tools import kernel_ab

    return kernel_ab.build_all({kernel_ab.FORCED[p]: (kernel_ab.forced_library, p)
                                for p in kernel_ab.FORCED})


@pytest.fixture(scope="module")
def forced_btd_libs():
    """This checkout's structured Anderson units built with each placement
    of the kept Gram and the chunk's system past memory 32 forced
    (tools/kernel_ab.py:forced_btd_library, -DAA_FORCE_SOLVE=p
    -DAA_FORCE_GRAM=g), all nvcc processes at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with --noconftest -m gpu")
    from sqp_solver_tpu_torch.tools import kernel_ab

    return kernel_ab.build_all({label: (kernel_ab.forced_btd_library, label)
                                for label in kernel_ab.FORCED_BTD})


@pytest.mark.parametrize("memory", [40, 65])
@pytest.mark.parametrize("kind", ["K1", "K3-block", "K3-warp"])
def test_anderson_forced_placements_are_the_rules_bit_for_bit(cuda, forced_aa_libs, kind,
                                                              memory):
    """K1 and K3 in each layout at memories 40 and 65 (chunks of 2, rho
    every 154, the ring wrapping) with the chunk's system in each place a
    build can force (the whole Gram area on chip, a solve area a problem,
    one a block, the workspace): each launch reports the forced placement
    and gives the rule's outputs bit for bit (the same operations in the
    same order wherever the system lives), so the same statuses and counts;
    a placement that shared memory cannot hold beside the kernel's own is
    refused by its launcher.  The rule's outputs are held to plain float64
    by test_anderson_kernels_past_memory_32_match_plain_float64."""
    t32, launch, _ = _aa_case(kind, memory, cuda, seg=2, rho_every=154, eps=1e-6, batch=512)
    ref = launch(t32)
    n, m = {"K1": (16, 17), "K3-block": (40, 41), "K3-warp": (16, 24)}[kind]
    assert (ref.iter >= 2 * (memory + 2)).float().mean() >= 0.25
    ran = []
    for name, lib in forced_aa_libs.items():
        try:
            placed = qk.anderson_placement_card(kind, n, m, memory, lib=lib)
        except RuntimeError:  # more shared memory than a block takes
            continue
        # one problem a block: its block's area is its own
        assert placed["solve"] == ("scope" if name == "block" and kind != "K3-warp" else name)
        out = _aa_case(kind, memory, cuda, seg=2, rho_every=154, eps=1e-6, batch=512,
                       lib=lib)[1](t32)
        torch.cuda.synchronize()
        for key in ref._fields:
            a, b = getattr(ref, key), getattr(out, key)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                   b.view(torch.int32) if b.dtype == torch.float32 else b), (
                    name, key)
        ran.append(name)
    assert {"scope", "workspace"} <= set(ran), ran


@pytest.mark.parametrize("memory", [40, 65])
@pytest.mark.parametrize("kind", AA_STRUCTURED)
def test_anderson_structured_forced_placements_are_the_rules_bit_for_bit(
        cuda, forced_btd_libs, kind, memory):
    """The structured kinds at memories 40 and 65 (chunks of 2, rho every
    154, the ring wrapping) with the kept Gram and the chunk's system in
    each place a build can force (tools/kernel_ab.py:FORCED_BTD: the
    parent's whole Gram area on chip with the system in it, solved by rows;
    the Gram area and a solve area on chip; the solve area alone; the Gram
    area alone, the system in the workspace; both in the workspace): each
    launch reports the forced placement and gives the rule's outputs bit for
    bit (the column solve stores every value of gamma with the bits of the
    serial elimination), so the same statuses and counts; a placement that
    shared memory cannot hold is refused by its launcher."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.tools.kernel_ab import FORCED_BTD

    t32, launch, _ = _aa_case(kind, memory, cuda, seg=2, rho_every=154, eps=1e-6, batch=512)
    ref = launch(t32)
    n, m, bb = AA_WIDE_SHAPES.get(kind, (32, 24, 8))
    cluster = {"K6-cluster": 2, "K6-block": 1}.get(kind, qb.cluster_size(n, m, bb, 512))
    placement = "wide" if bb > 32 else kind[:2]
    nnz = qb.compact_nnz(t32["J"], bb) if bb > qb.COMPACT_ABOVE else None
    ran = []
    for name, lib in forced_btd_libs.items():
        try:
            placed = qk.anderson_placement_card(placement, n, m, memory, bb=bb, cluster=cluster,
                                                nnz=nnz, lib=lib)
            out = _aa_case(kind, memory, cuda, seg=2, rho_every=154, eps=1e-6, batch=512,
                           lib=lib)[1](t32)
        except (RuntimeError, ValueError):  # more shared memory than a block takes
            continue
        solve, gram = FORCED_BTD[name]
        assert (placed["solve"], placed["gram"]) == (
            ("gram", "scope", "block", "workspace")[solve], bool(gram) or solve == 0), name
        torch.cuda.synchronize()
        for key in ref._fields:
            a, b = getattr(ref, key), getattr(out, key)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                   b.view(torch.int32) if b.dtype == torch.float32 else b), (
                    name, key)
        ran.append(name)
    assert {"scope", "workspace"} <= set(ran), ran


@pytest.mark.parametrize("kind", AA_KINDS)
def test_anderson_kernels_take_every_memory_through_leg_g(cuda, kind):
    """Every memory from 1 to 40, the largest leg G runs
    (chip_smoke.AA_LONG_MEMORY), launches without a refusal (the Gram area
    on chip, or K1's and K3's system in a solve area or the workspace,
    wherever the rule puts it) and gives finite iterates."""
    for memory in range(1, 41):
        t32, launch, _ = _aa_case(kind, memory, cuda, seg=2, batch=32)
        out = launch(t32)
        x = out.p if kind == "K1" else out.x
        assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(out.y).all()), memory


@pytest.mark.parametrize("kind", ["K3-block", "K3-warp", "K6-block", "K6-cluster"])
def test_anderson_kernels_certificates(cuda, kind):
    """The certificate batch (feasible, primal and dual infeasible problems
    by turns, n = 16, m = 18) with Anderson (memory 4) and certificates on,
    through K3 in each layout and K6 (internal block 8, T = 2) on one block
    and on a cluster: the statuses equal the plain version's and the batch's
    pattern."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    s = dataclasses.replace(QP_BENCH, acceleration="anderson")
    t = _to(certificate_qp_inputs(96, 16, seed=5), cuda)
    if kind.startswith("K3"):
        layout = kind.split("-")[1]
        ok = qk.qp_status(_qp_raw(lambda *a: qk._qp_solve_launch(*a, layout=layout), t, s))
        ref = qk.qp_status(_qp_raw(qk.qp_solve_reference, t, s))
    else:
        pd, pe = qb.extract_band(t["P"], 8)
        tb = dict(pd=pd, pe=pe, J=t["A"], g=t["q"], l=t["l"], u=t["u"], x=t["x"], z=t["z"],
                  y=t["y"])
        bs = dataclasses.replace(s, linear_solver="schur_block_tridiag", block_size=8)
        cl = 2 if kind == "K6-cluster" else 1
        ok = qk.qp_status(_btd_raw(qb._qp_btd_launch, tb, bs, active=None, rho_in=None,
                                   check_infeas=True, name="test", cluster=cl))
        ref = qk.qp_status(_btd_raw(qb.qp_btd_reference, tb, bs, check_infeas=True))
    torch.cuda.synchronize()
    assert torch.equal(ok, ref)
    want = torch.tensor([QPStatus.SOLVED, QPStatus.PRIMAL_INFEASIBLE,
                         QPStatus.DUAL_INFEASIBLE] * 32, dtype=torch.int32, device=ok.device)
    assert torch.equal(ok, want)


# (kernel, n, m, internal block, blocks a problem): the Anderson kernels of
# leg G's shapes, the card tests' and those past shared memory (the wide
# kernel at the control class's shape at 50 states: the compact route's
# cluster of eight for leg P's nonzeros)
AA_PLACEMENTS = [("K1", 32, 33, None, None), ("K1", 128, 129, None, None),
                 ("K1", 16, 17, None, None), ("K3-warp", 32, 33, None, None),
                 ("K3-warp", 16, 24, None, None), ("K3-block", 32, 33, None, None),
                 ("K3-block", 40, 41, None, None), ("K3-block", 64, 900, None, None),
                 ("K6", 192, 320, 8, 2), ("K6", 192, 320, 8, 1), ("K7", 128, 224, 8, 2),
                 ("K6", 32, 24, 8, 1), ("wide", 256, 384, 64, 2), ("wide", 360, 600, 40, 2),
                 ("wide", 128, 224, 64, 2), ("wide", 760, 1250, 152, 8),
                 ("wide", 512, 200, 256, 8), ("wide", 80, 60, 40, 2), ("wide", 272, 128, 136, 4)]


@pytest.mark.parametrize("kernel,n,m,bb,cluster", AA_PLACEMENTS,
                         ids=[f"{c[0]}-n{c[1]}-m{c[2]}-cs{c[4]}" for c in AA_PLACEMENTS])
def test_anderson_placement_is_the_rules(cuda, kernel, n, m, bb, cluster):
    """The placement the launcher reports (qp_kernel_aa_placement,
    qp_btd_aa_placement, qp_btd_wide_layout_nnz; past internal block 128
    for leg P's nonzeros) equals the rule's Python
    mirror (ops/qp_kernel.py:anderson_placement) given the card's blocks an
    SM of the kernel without Anderson; with the ring on chip the Anderson
    kernel's blocks an SM are no fewer than those; memories 4 and 8 (the Gram
    area in shared memory always) and 33, 40, 64, 65 and 128 (past 32 the
    chunk's system off the Gram area, ``solve``: K1's and K3's in a solve
    area or the workspace, their Gram area there always; the structured
    kernels' Gram area and solve area each on chip only where it costs the
    kernel without Anderson nothing: for the wide kernel, given its layouts
    with each reserve the rule weighs, qp_btd_wide_layout_reserve)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    nnz = (_leg_p(cuda)[1] if (n, bb) == (760, 152) else None) if kernel == "wide" else None
    for k in (4, 8, 33, 40, 64, 65, 128):
        card = qk.anderson_placement_card(kernel, n, m, k, bb=bb, cluster=cluster, nnz=nnz)
        wide = None
        if kernel == "wide":
            plain = qb.wide_layout(n, m, bb, nnz=nnz)

            def wide(reserve):
                return qb.wide_layout(n, m, bb, nnz=nnz, reserve=reserve)

            assert card["gram"] or k > 32
            if k > 32 and (card["gram"] or card["solve"] == "scope"):
                assert card["workspace_floats"] == plain["workspace_floats"], card
        mirror = qk.anderson_placement(kernel, n, m, k, twin_blocks=card.get("twin_blocks"),
                                       bb=bb, cluster=cluster, wide=wide)
        assert {key: card[key] for key in mirror if key in card} == {
            key: v for key, v in mirror.items() if key in card}, (card, mirror)
        on_chip = card["gram"] or card["solve_floats"]  # past 32, K6's and K7's keep the twin's
        if kernel != "wide" and (card["ring"] or (k > 32 and on_chip and kernel in ("K6", "K7"))):
            assert card["blocks"] >= card["twin_blocks"], card


def test_anderson_kernels_cut_iterations(cuda):
    """K3 with Anderson (memory 4) against K3 without on the one-shot cell's
    problems at tight tolerances (bench.py:1387-1396's settings, B = 256):
    fewer mean ADMM iterations, every problem SOLVED."""
    from sqp_solver_tpu_torch.models.mpc import random_qp_batch

    qp = random_qp_batch(256, 32, 33, seed=3, device=cuda)
    s = QPSettings(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=2000, check_termination=25,
                   schedule="fixed")
    before = qk.qp_solve_launches
    plain = qk.qp_solve_kernel(qp, s)
    aa = qk.qp_solve_kernel(qp, dataclasses.replace(s, acceleration="anderson"))
    assert qk.qp_solve_launches - before == 2
    assert (aa.info.status == QPStatus.SOLVED).all()
    assert aa.info.iter.float().mean() < plain.info.iter.float().mean()


def test_no_acceleration_is_the_parents_bit_for_bit(cuda):
    """Without Anderson, K1-K7 give the parent tree's outputs bit for bit at
    the chip_smoke.py shapes and use its registers, stack and local bytes,
    and the Anderson instantiations its outputs at leg G's shapes
    (tools/kernel_ab.py --parts bits,regs); the parent tree is named by
    KERNEL_AB_PARENT (a ``git archive`` of the parent commit)."""
    parent = os.environ.get("KERNEL_AB_PARENT")
    if not parent:
        pytest.skip("set KERNEL_AB_PARENT to an unpacked parent tree")
    from sqp_solver_tpu_torch.tools import kernel_ab

    assert kernel_ab.main(["--parent", parent, "--parts", "bits,regs"]) == 0


BACKEND_NAMES = ["kkt_ldlt", "cg", "schur_cholesky_tri", "schur_cholesky_blocked",
                 "schur_block_tridiag"]


@pytest.mark.parametrize("name", BACKEND_NAMES)
def test_backends_on_cuda_float64_match_cpu(cuda, name):
    """Each linear-solver backend under the vmap tier (and the block-
    tridiagonal one under the fused tier) on CUDA float64 tensors against
    the CPU: statuses and counts equal, x, y, z within 1e-9."""
    from sqp_solver_tpu_torch.models.mpc import mpc_qp_stagewise_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    if name == "schur_block_tridiag":
        qp, b = mpc_qp_stagewise_batch(16, horizon=8, seed=5, dtype=torch.float64,
                                       device="cpu")
        a = {k: getattr(qp, k).numpy() for k in LEAVES}
        extra, impls = dict(block_size=b), ("vmap", "fused")
    else:
        a, extra, impls = qp_inputs(32, 8, 10, seed=9, loose_row=True), {}, ("vmap",)
    s = QPSettings(**dict(VMAP_QP, adaptive_rho=True, adaptive_rho_interval=50,
                          linear_solver=name, **extra))
    for impl in impls:
        res = {}
        for dev in ("cpu", cuda):
            qp = QuadraticProblem(*(torch.as_tensor(a[k], dtype=torch.float64).to(dev)
                                    for k in LEAVES))
            res[str(dev)] = qp_solve_batch(qp, s, impl=impl)
        c, g = res["cpu"], res["cuda"]
        for k in ("status", "iter", "rho_updates"):
            assert torch.equal(getattr(c.info, k), getattr(g.info, k).cpu()), (impl, k)
        for k in ("x", "y", "z"):
            torch.testing.assert_close(getattr(g, k).cpu(), getattr(c, k), atol=1e-9, rtol=0)
        assert bool((c.info.status == QPStatus.SOLVED).all()), impl


def test_arrow_and_sparse_cg_on_cuda_float64_match_cpu(cuda):
    """schur_arrow on the vmap and fused tiers and BlockSparse operands on
    cg (one problem, ``qp_solve``) on CUDA float64 tensors against the CPU:
    statuses and counts equal, x, y within 1e-9; neither launches a
    kernel."""
    from sqp_solver_tpu_torch.models.mpc import mpc_qp_coupled_batch
    from sqp_solver_tpu_torch.models.sparse import sparse_qp_pair
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp import qp_solve

    runs = []
    for impl in ("vmap", "fused"):
        s = QPSettings(adaptive_rho=True, max_iter=2000, linear_solver="schur_arrow",
                       block_size=4, arrow_width=2)
        runs.append((impl, lambda dev, s=s, impl=impl: qp_solve_batch(
            mpc_qp_coupled_batch(8, agents=6, horizon=4, dtype=torch.float64, device=dev)[0],
            s, impl=impl)))
    cg = QPSettings(linear_solver="cg", eps_abs=1e-7, eps_rel=1e-7, max_iter=2000,
                    check_termination=25, adaptive_rho=True)
    runs.append(("sparse", lambda dev: qp_solve(
        sparse_qp_pair(n=128, m=128, bs=32, density=0.3, seed=8, dtype=torch.float64,
                       device=dev)[1], cg)))
    for label, run in runs:
        res = []
        for dev in ("cpu", cuda):
            before = _counts()
            res.append(run(dev))
            assert _launched(before) == (0, 0, 0, 0), label
        c, g = res
        for k in ("status", "iter", "rho_updates"):
            assert torch.equal(getattr(c.info, k), getattr(g.info, k).cpu()), (label, k)
        for k in ("x", "y"):
            torch.testing.assert_close(getattr(g, k).cpu(), getattr(c, k), atol=1e-9, rtol=0)
        assert bool((c.info.status == QPStatus.SOLVED).all()), label


def test_diff_layers_backward_on_cuda_match_plain(cuda):
    """Both differentiable layers' backward on CUDA float32 tensors, through
    K2 (and for the QP layer also through K4), against the plain route on
    the CPU at the same solution; then ``qp_solve_diff`` end to end on the
    fused tier, its gradients finite."""
    from sqp_solver_tpu_torch.models.benchmark import exp_chain_nlp_batch_device
    from sqp_solver_tpu_torch.models.mpc import random_qp_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
    from sqp_solver_tpu_torch.qp.diff import qp_solve_diff, qp_solve_vjp
    from sqp_solver_tpu_torch.sqp.diff import sqp_solve_vjp
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    qs = QPSettings(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=2000, check_termination=25,
                    adaptive_rho=True, polish=True)
    qp = random_qp_batch(64, 16, 24, seed=3, device="cpu")
    res = qp_solve_batch(qp, qs)
    g = torch.as_tensor(np.random.default_rng(4).normal(size=(64, 16)), dtype=torch.float32)
    args = (qp.P, qp.A, qp.l, qp.u, res.x, res.y, res.info.status, g)
    ref = qp_solve_vjp(*args, qs, use_kernel=False)
    for route, counter in ((True, "polish_kkt_launches"), (False, "spd_inverse_launches")):
        before = getattr(qk, counter)
        out = qp_solve_vjp(*(a.to(cuda) for a in args), qs, use_kernel=route)
        assert getattr(qk, counter) == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.cpu(), b, **TOL)
    assert ref[1].abs().max() > 0

    ss = SQPSettings(max_iter=24, eps_prim=1e-3, eps_dual=1e-3, termination="kkt",
                     schedule="fixed", qp_impl="kernel", polish=True, polish_passes=2,
                     line_search_max_iter=6, qp=MAIN_QP)
    prob, x0 = exp_chain_nlp_batch_device(5, 64, 16, device="cpu")
    sres = sqp_solve_batch(prob, x0, None, ss, impl="fused")
    gs = torch.ones_like(sres.x)
    sref = sqp_solve_vjp(prob, sres.x, sres.lam, sres.info.status, gs, ss)
    gprob = dataclasses.replace(prob, l=prob.l.to(cuda), u=prob.u.to(cuda),
                                params=prob.params.to(cuda))
    before = qk.polish_kkt_launches
    sout = sqp_solve_vjp(gprob, sres.x.to(cuda), sres.lam.to(cuda), sres.info.status.to(cuda),
                         gs.to(cuda), ss)
    assert qk.polish_kkt_launches == before + 1
    for a, b in zip(sout, sref):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    assert sref[2].abs().max() > 0

    leaves = {k: getattr(qp, k).to(cuda).requires_grad_(True) for k in LEAVES}
    before = qk.polish_kkt_launches
    x = qp_solve_diff(QuadraticProblem(**leaves), dataclasses.replace(qs, schedule="fixed",
                                                                      max_iter=200), "fused")
    (x * x).sum().backward()
    assert qk.polish_kkt_launches > before
    for k in LEAVES:
        assert torch.isfinite(leaves[k].grad).all(), k
