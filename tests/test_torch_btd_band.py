"""The wide structured kernel's band-row layout (``ops/qp_kernel_btd.py:band_rows``).

A row of A that touches at most two consecutive column blocks keeps its
2 bb entries from its first nonzero column block (at most T - 2); A v, A' w
and the Gram band of A' diag(rho) A then read only those.  Here, on the
CPU in float64: the layout on random band QPs, on the OSQP control class's
arm and on a batch in which one problem has a row across three column
blocks (that problem alone does not fit); the band products against the
dense ones at 1e-12 (the same terms summed in another order); and the wide
route's plain version, which runs on the band rows where a problem fits and
densely where it does not, against the JAX package's kernels in interpret
mode at the tolerances of ``tests/test_torch_btd_wide.py`` (statuses,
iteration and rho-update counts equal, x, y, z to atol 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel_btd import btd_step_kernel as jax_btd_step
from sqp_solver_tpu.ops.qp_kernel_btd import qp_solve_kernel_btd as jax_qp_btd
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
from sqp_solver_tpu_torch.qp.types import QPSettings, QPStatus
from sqp_solver_tpu_torch.testing import (
    btd_qp_inputs,
    btd_route_inputs,
    btd_step_inputs,
    control_qp_inputs,
)

ATOL = 1e-9
LEAVES = ("P", "q", "A", "l", "u")
BTD = dict(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
           adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
           linear_solver="schur_block_tridiag")


def _control_padded():
    """The control arm at horizon 4 (n = 72) padded to the internal block 40
    of its declared stage block 18 (n = 80), as ``qp_solve_kernel_btd``
    pads it."""
    a = control_qp_inputs(3, horizon=4, seed=0)
    A = np.pad(a["A"], ((0, 0), (0, 0), (0, 8)))
    return A, 40


# (name, A, internal block, fits per problem)
def _cases():
    rnd = btd_qp_inputs(3, 4, 40, 30, seed=1)["A"]
    ctl, bb = _control_padded()
    mixed = btd_route_inputs(4, 3, 40, 30, seed=2, dense=(2,))["A"]
    wide = btd_qp_inputs(2, 2, 64, 20, seed=3)["A"]
    one = btd_qp_inputs(2, 1, 48, 12, seed=4)["A"]
    return [("random", rnd, 40, [True] * 3), ("control", ctl, bb, [True] * 3),
            ("mixed", mixed, 40, [True, True, False, True]), ("T2", wide, 64, [True] * 2),
            ("T1", one, 48, [True] * 2)]


CASES = {c[0]: c for c in _cases()}


def _np_band(A, bb):
    """k_r and fits from the definition, row by row."""
    B, m, n = A.shape
    T = n // bb
    kr = np.zeros((B, m), np.int64)
    fits = np.ones(B, bool)
    for b in range(B):
        for r in range(m):
            nz = np.nonzero(A[b, r])[0]
            if nz.size == 0:
                continue
            first, last = nz[0] // bb, nz[-1] // bb
            kr[b, r] = min(first, max(T - 2, 0))
            fits[b] &= last <= kr[b, r] + 1
    return kr, fits


@pytest.mark.parametrize("name", list(CASES))
def test_band_rows_layout(name):
    """k_r, the slabs and the route per problem: only a problem with a row
    across more than two column blocks fails to fit, and a fitting row's
    nonzeros all lie in its slab."""
    _, A, bb, want = CASES[name]
    kr, slabs, fits = qb.band_rows(torch.as_tensor(A), bb)
    np_kr, np_fits = _np_band(A, bb)
    assert fits.tolist() == want == np_fits.tolist()
    np.testing.assert_array_equal(kr.numpy(), np_kr)
    B, m, n = A.shape
    W = min(2, n // bb) * bb
    assert slabs.shape == (B, m, W)
    for b in range(B):
        for r in range(m):
            lo = np_kr[b, r] * bb
            np.testing.assert_array_equal(slabs[b, r].numpy(), A[b, r, lo:lo + W])
            if want[b]:
                assert not np.any(np.delete(A[b, r], np.arange(lo, lo + W)))


def test_band_rows_counts_nan_as_nonzero():
    """A NaN outside a row's two blocks makes its problem take the dense
    route, where the dense products carry it as the JAX kernel does."""
    A = btd_qp_inputs(2, 3, 40, 10, seed=5)["A"]
    A[0, 3, 2 * 40 + 5] = np.nan
    A[0, 3, :40] = 0.0
    _, _, fits = qb.band_rows(torch.as_tensor(A), 40)
    assert fits.tolist() == [True, True]
    A[1, 0, 2 * 40 + 5] = np.nan
    _, _, fits = qb.band_rows(torch.as_tensor(A), 40)
    assert fits.tolist() == [True, False]


@pytest.mark.parametrize("name", list(CASES))
def test_band_products_match_dense(name):
    """A v, A' w and the Gram band (D_k, E_k) from the band rows against
    the dense products, at 1e-12 on the problems that fit."""
    _, A, bb, want = CASES[name]
    At = torch.as_tensor(A)
    B, m, n = At.shape
    T = n // bb
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.standard_normal((B, n)))
    w = torch.as_tensor(rng.standard_normal((B, m)))
    rv = torch.as_tensor(rng.uniform(0.1, 10.0, (B, m)))
    band = qb.band_rows(At, bb)
    ok = torch.as_tensor(want)
    torch.testing.assert_close(qb._band_amv(band, v, bb)[ok], qk._mv(At, v)[ok], atol=1e-12,
                               rtol=0)
    torch.testing.assert_close(qb._band_atmv(band, w, bb, n)[ok], qk._mtv(At, w)[ok],
                               atol=1e-12, rtol=0)
    Db, Eb = qb._band_gram(band, rv, T, bb)
    Dd, Ed = qb._dense_gram(At, rv, T, bb)
    torch.testing.assert_close(Db[ok], Dd[ok], atol=1e-12, rtol=0)
    torch.testing.assert_close(Eb[ok], Ed[ok], atol=1e-12, rtol=0)


def test_wide_route_factor_and_reference_match_dense():
    """The plain version's factor and solve with the band rows (dense where
    a problem does not fit) against the dense oracle: the factor at 1e-12,
    the solve's counts equal and its iterates at 1e-10; the route reported
    per problem."""
    a = btd_route_inputs(4, 3, 40, 30, seed=2, dense=(2,))
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    pd, pe = qb.extract_band(t["P"], 40)
    rv = torch.full((4, 30), 0.7, dtype=torch.float64)
    (Lb, Gb, Hb), fb = qb._btd_factor(pd, pe, t["A"], rv, 1e-6, qb.band_rows(t["A"], 40))
    (Ld, Gd, Hd), fd = qb._btd_factor(pd, pe, t["A"], rv, 1e-6)
    assert torch.equal(fb, fd)
    for x, y in ((Lb, Ld), (Gb, Gd), (Hb, Hd)):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=0)
    s = QPSettings(**dict(BTD, block_size=40))
    args = (pd, pe, t["A"], t["q"], t["l"], t["u"], t["x"], t["z"], t["y"], s)
    band = qb.qp_btd_reference(*args, check_infeas=True, band=True)
    dense = qb.qp_btd_reference(*args, check_infeas=True)
    assert band.band.tolist() == [True, True, False, True] and dense.band is None
    for k in ("iter", "rho_updates", "done", "fail", "infs"):
        assert torch.equal(getattr(band, k), getattr(dense, k)), k
    for k in ("x", "z", "y"):
        torch.testing.assert_close(getattr(band, k), getattr(dense, k), atol=1e-10, rtol=0)


def test_wide_route_mixed_batch_matches_jax():
    """K6's plain version on the CPU (the wide route: band rows where a
    problem fits, dense rows where one of its rows spans three column
    blocks) against the JAX kernel on a batch of both kinds."""
    a = btd_route_inputs(3, 3, 40, 48, seed=40, dense=(1,), loose_row=True)
    s = dict(BTD, block_size=40)
    jr = jax_qp_btd(JaxQP(*(jnp.asarray(a[k]) for k in LEAVES)), JaxQPSettings(**s))
    pr = qb.qp_solve_kernel_btd(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"),
                                QPSettings(**s))
    p = interop.qp_result_to_numpy(pr)
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(p[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    np.testing.assert_allclose(p["rho_estimate"], np.asarray(jr.info.rho_estimate), rtol=1e-6)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k], np.asarray(getattr(jr, k)), atol=ATOL, rtol=0,
                                   err_msg=k)
    assert (p["status"] == QPStatus.SOLVED).all()
    assert qb.band_rows(torch.as_tensor(a["A"]), 40)[2].tolist() == [True, False, True]


def test_wide_step_mixed_batch_matches_jax():
    """K7's plain version on the CPU on a batch whose second problem takes
    the dense route (a carried rho on every second problem, the last one
    inactive) against the JAX kernel: iterates and the nine stats rows,
    and the route it reports."""
    t = btd_step_inputs(3, 3, 40, 48, seed=12)
    t["J"][1, 0, 2 * 40] = 1e-3  # a row across three column blocks
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
    assert out.band.tolist() == [True, False, True]
    for name, x, y in (("p", out.x, jp), ("z", out.z, jz), ("y", out.y, jy)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y).T, atol=ATOL, rtol=0, err_msg=name)
    rows = (out.done, out.iter, out.res_prim, out.res_dual, out.fail, out.rho_updates,
            out.rho_estimate, out.infs, out.rho_factor)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r.double().numpy(), np.asarray(st)[i], rtol=1e-6,
                                   atol=1e-12, err_msg=f"stats row {i}")


def test_cpu_route_counts_nothing():
    """On the CPU the wrappers run the plain version: no launch, and the
    wide kernel's route tally stays as it was."""
    before = (qb.qp_solve_btd_wide_launches, qb.btd_step_wide_launches,
              qb.wide_route_counts())
    a = btd_qp_inputs(2, 2, 40, 12, seed=9)
    qb.qp_solve_kernel_btd(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"),
                           QPSettings(**dict(BTD, block_size=40, max_iter=50)))
    assert (qb.qp_solve_btd_wide_launches, qb.btd_step_wide_launches,
            qb.wide_route_counts()) == before


def test_route_inputs_need_three_blocks():
    with pytest.raises(ValueError, match="T >= 3"):
        btd_route_inputs(2, 2, 40, 10)


def test_route_tally_sums_each_launch():
    """The wrappers' route tally (what a wide launch adds, on the route
    tensor's own device, with no read back to the host): band and dense
    problems summed over launches until reset."""
    qb.reset_wide_route_counts()
    try:
        qb._count_routes(torch.tensor([True, False, True, True]))
        qb._count_routes(torch.tensor([False, False]))
        qb._count_routes(torch.ones(0, dtype=torch.bool))
        assert qb.wide_route_counts() == dict(band=3, dense=3)
    finally:
        qb.reset_wide_route_counts()
    assert qb.wide_route_counts() == dict(band=0, dense=0)
