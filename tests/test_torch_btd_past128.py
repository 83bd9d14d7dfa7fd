"""The wide structured kernel's compact route past internal block 128.

Past ``ops/qp_kernel_btd.py:COMPACT_ABOVE`` the wide kernel holds A's band
rows by their nonzeros (``compact_rows``: each row's slab start k_r, its
nonzero entries in column order with their columns inside the slab), in a
cluster of 2, 4 or 8 blocks that its layout rule
(``csrc/qp_kernel_btd_wide.cu:xwide_rule``, which the card's tests hold)
picks for the nonzeros a block holds (``compact_nnz``).  Here, on the CPU
in float64, without JAX:

* the compact rows' products (A v, A' w, the Gram band) against the band
  rows' at atol 1e-13, on the OSQP control class at 50 states (internal
  block 152) and on random band QPs at internal blocks 136 and 256, with
  most of their band entries zeroed, so that the two layouts differ;
* a NaN in an iterate reaches exactly the rows (or columns) with a nonzero
  in its column (or row), where the band rows' products carry it to every
  row whose slab covers the column (ROADMAP's documented divergences);
* the nonzeros a block holds at each cluster (``compact_nnz``), a NaN in A
  counting as one, as the kernel's load phase counts it;
* the plain version on the compact route against the dense oracle
  (``band=False``): K6 and K7 at internal block 136, and a batch of both
  routes at 136, statuses and counts equal, x, z, y to atol 1e-9.

The JAX package's parity past 128 stays in ``tests/test_torch_card_limits.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
from sqp_solver_tpu_torch.qp.types import QPSettings
from sqp_solver_tpu_torch.testing import (
    btd_qp_inputs,
    btd_route_inputs,
    btd_step_inputs,
    control_qp_inputs,
)

ATOL = 1e-9
BTD = QPSettings(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=150, check_termination=25,
                 adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed",
                 linear_solver="schur_block_tridiag")


def _control50():
    """The control class at 50 states and 25 inputs over 10 steps (n = 750,
    m = 1,250), A padded to the internal block 152 of its declared stage
    block 75 (n = 760), as ``qp_solve_kernel_btd`` pads it."""
    a = control_qp_inputs(2, horizon=10, nx=50, nu=25, seed=0)
    return np.pad(a["A"], ((0, 0), (0, 0), (0, 10))), 152


def _sparse_band(T, bb, m, seed):
    """Random band rows (``btd_qp_inputs``) with about four in five of their
    entries zeroed."""
    A = btd_qp_inputs(2, T, bb, m, seed=seed)["A"]
    keep = np.random.default_rng(seed).uniform(size=A.shape) < 0.2
    return A * keep, bb


CASES = {"control50": _control50, "bb136": lambda: _sparse_band(2, 136, 40, 7),
         "bb256": lambda: _sparse_band(3, 256, 30, 8)}


def _rows(name):
    A, bb = CASES[name]()
    At = torch.as_tensor(A)
    band = qb.band_rows(At, bb)
    return At, bb, band, qb.compact_rows(band)


@pytest.mark.parametrize("name", list(CASES))
def test_compact_products_match_band_rows(name):
    """A v, A' w and the Gram band from the compact rows equal the band
    rows' at atol 1e-13 (the same nonzero terms, summed in another order)."""
    A, bb, band, rows = _rows(name)
    B, m, n = A.shape
    T = n // bb
    rng = np.random.default_rng(1)
    v = torch.as_tensor(rng.standard_normal((B, n)))
    w = torch.as_tensor(rng.standard_normal((B, m)))
    rv = torch.as_tensor(rng.uniform(0.1, 10.0, (B, m)))
    assert band[2].all()
    torch.testing.assert_close(qb._compact_amv(rows, v, bb), qb._band_amv(band, v, bb),
                               atol=1e-13, rtol=0)
    torch.testing.assert_close(qb._compact_atmv(rows, w, bb, n), qb._band_atmv(band, w, bb, n),
                               atol=1e-13, rtol=0)
    for got, want in zip(qb._compact_gram(rows, rv, T, bb), qb._band_gram(band, rv, T, bb)):
        torch.testing.assert_close(got, want, atol=1e-13, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_compact_rows_hold_the_nonzeros(name):
    """Each row's entries are its nonzeros in column order, their columns
    inside the slab, and nothing else: at the control shape under a tenth
    of the band rows' entries."""
    A, bb, band, rows = _rows(name)
    k_r, slabs, _ = band
    nnz = int((A != 0).sum())
    assert int(rows.valid.sum()) == nnz
    for b in range(A.shape[0]):
        for r in range(0, A.shape[1], 7):
            cols = rows.cols[b, r][rows.valid[b, r]]
            want = torch.nonzero(slabs[b, r]).flatten()
            assert torch.equal(cols, want)
            assert torch.equal(rows.vals[b, r][rows.valid[b, r]], slabs[b, r][want])
    assert not rows.vals[~rows.valid].any()
    if name == "control50":
        assert nnz < 0.1 * slabs.numel()


@pytest.mark.parametrize("name", list(CASES))
def test_nan_reaches_exactly_the_rows_with_a_nonzero(name):
    """A NaN in v's column j reaches the rows of A v with a nonzero in
    column j, and no other; one in w's row r reaches the columns of A' w
    where row r has a nonzero.  The band rows' products carry both to
    every row (column) whose slab covers it, as dense A does (0 * NaN)."""
    A, bb, band, rows = _rows(name)
    B, m, n = A.shape
    j, r = n // 2 + 11, m // 2
    v = torch.zeros((B, n), dtype=A.dtype)
    v[:, j] = float("nan")
    got = torch.isnan(qb._compact_amv(rows, v, bb))
    assert torch.equal(got, A[:, :, j] != 0)
    covers = (band[0] * bb <= j) & (j < band[0] * bb + band[1].shape[-1])
    assert torch.equal(torch.isnan(qb._band_amv(band, v, bb)), covers)
    assert int(covers.sum()) > int(got.sum()) > 0
    w = torch.zeros((B, m), dtype=A.dtype)
    w[:, r] = float("nan")
    got = torch.isnan(qb._compact_atmv(rows, w, bb, n))
    assert torch.equal(got, A[:, r] != 0)
    assert int(torch.isnan(qb._band_atmv(band, w, bb, n)).sum()) > int(got.sum()) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_compact_nnz_counts_each_blocks_rows(name):
    """compact_nnz: the most nonzeros a block holds at clusters of 2, 4 and
    8, block r holding the rows r, r + cs, ... of its problem."""
    A, bb, _, _ = _rows(name)
    per_row = (A != 0).sum(-1).numpy()
    want = tuple(max(int(per_row[b, r::cs].sum()) for b in range(A.shape[0])
                     for r in range(cs)) for cs in qb.COMPACT_CLUSTERS)
    assert qb.compact_nnz(A, bb) == want
    assert want[0] > want[1] > want[2] > 0


def test_a_nan_in_a_counts_as_a_nonzero():
    """A NaN entry of A is one of its row's entries in compact_rows (in its
    column order) and in compact_nnz, so that A v and A' w carry it as the
    band rows do."""
    A, bb, _, _ = _rows("bb136")
    A = A.clone()
    r = 5
    j = int(torch.nonzero(A[0, r] == 0)[0])
    A[0, r, j] = float("nan")
    band = qb.band_rows(A, bb)
    rows = qb.compact_rows(band)
    lone = torch.zeros_like(A)
    lone[0, r, j] = float("nan")
    assert qb.compact_nnz(lone, bb) == (1, 1, 1)
    assert int(rows.valid[0, r].sum()) == int((A[0, r] != 0).sum()) == int(
        (_rows("bb136")[0][0, r] != 0).sum()) + 1
    slot = int(torch.nonzero(torch.isnan(rows.vals[0, r]))[0])
    assert bool(rows.valid[0, r, slot])
    assert int(rows.cols[0, r, slot]) == j - int(band[0][0, r]) * bb
    cols = rows.cols[0, r][rows.valid[0, r]]
    assert torch.equal(cols, torch.sort(cols).values)
    v = torch.ones((A.shape[0], A.shape[2]), dtype=A.dtype)
    assert torch.equal(torch.isnan(qb._compact_amv(rows, v, bb)),
                       torch.isnan(qb._band_amv(band, v, bb)))


def _raw(t, s, band, **kw):
    return qb.qp_btd_reference(t["pd"], t["pe"], t["J"], t["g"], t["l"], t["u"], t["x"],
                               t["z"], t["y"], s, band=band, **kw)


def _assert_same(got, want):
    for k in ("done", "iter", "fail", "infs", "rho_updates"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in ("x", "z", "y"):
        torch.testing.assert_close(getattr(got, k), getattr(want, k), atol=ATOL, rtol=0)


@pytest.mark.parametrize("entry", ["K6", "K7"])
def test_compact_route_matches_the_dense_oracle(entry):
    """The plain version on the compact route at internal block 136 (band
    QPs with most band entries zeroed) against itself with A dense: K6
    cold-started with certificates, K7 with a carried rho and an inactive
    problem."""
    s = dataclasses.replace(BTD, block_size=136)
    if entry == "K6":
        a = btd_qp_inputs(3, 2, 136, 40, seed=21)
        a["A"] = a["A"] * (np.random.default_rng(21).uniform(size=a["A"].shape) < 0.3)
        P = torch.as_tensor(a["P"])
        pd, pe = qb.extract_band(P, 136)
        t = dict(pd=pd, pe=pe, J=torch.as_tensor(a["A"]), g=torch.as_tensor(a["q"]),
                 l=torch.as_tensor(a["l"]), u=torch.as_tensor(a["u"]),
                 x=torch.zeros((3, 272), dtype=torch.float64),
                 z=torch.zeros((3, 40), dtype=torch.float64),
                 y=torch.zeros((3, 40), dtype=torch.float64))
        kw = dict(check_infeas=True)
    else:
        a = btd_step_inputs(3, 2, 136, 40, seed=22)
        t = {k: torch.as_tensor(v) for k, v in a.items()}
        kw = dict(active=t["active"], rho_in=t["rho_in"])
    got = _raw(t, s, True, **kw)
    assert got.band.all()
    _assert_same(got, _raw(t, s, False, **kw))
    assert int(got.iter.max()) > 0


def test_compact_route_mixed_batch_matches_the_dense_oracle():
    """A batch at internal block 136 (T = 3) in which one problem has a row
    across three column blocks: it takes the dense route, the others the
    compact rows, and both match the dense oracle."""
    a = btd_route_inputs(3, 3, 136, 30, seed=23, dense=(1,))
    P = torch.as_tensor(a["P"])
    pd, pe = qb.extract_band(P, 136)
    zx, zm = torch.zeros((3, 408), dtype=torch.float64), torch.zeros((3, 30),
                                                                     dtype=torch.float64)
    t = dict(pd=pd, pe=pe, J=torch.as_tensor(a["A"]), g=torch.as_tensor(a["q"]),
             l=torch.as_tensor(a["l"]), u=torch.as_tensor(a["u"]), x=zx, z=zm, y=zm)
    s = dataclasses.replace(BTD, block_size=136)
    got = _raw(t, s, True, check_infeas=True)
    assert got.band.tolist() == [True, False, True]
    _assert_same(got, _raw(t, s, False, check_infeas=True))
