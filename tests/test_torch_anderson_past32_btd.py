"""The structured kernels' Anderson step past memory 32 on the CPU: where
the chunk's system goes, and the plain K7 with Anderson at memories whose
ring fills and wraps.

Past memory 32 K6 and K7 (``csrc/qp_kernel_btd.cu:btd_aa_plan``) and the
wide kernel (``csrc/qp_kernel_btd_wide.cu:wide_aa_plan``, both routes) put
the chunk's system in a solve area by columns that the whole block solves
(``solve`` "scope", in shared memory) or in the workspace, and keep the Gram
area (the kept Gram) in shared memory or in the workspace: each area on chip
only where it costs the kernel without Anderson nothing (no row of A, no
array in shared memory, no block an SM), the two together first, else the
solve area alone, else the Gram area alone.  The Python mirror is
``ops/qp_kernel.py:anderson_placement``.

* The mirror at leg G's shapes (K6 on the MPC at horizon 64 and K7 on the
  NLP step at horizon 32, each on a cluster; the wide K6 on random bands at
  bb = 64 and the wide K7 at the NLP's block-64 shape, given their layouts)
  at memories 33, 40, 64, 65 and 128, against placements worked by hand.
* No memory from 1 to 5,000 refused, and none past 32 that costs the
  kernel without Anderson a row of A, an array or a block an SM.
* The port's plain K7 (``ops/qp_kernel_btd.py:btd_step_kernel`` on the
  CPU) with Anderson at memories 40 and 65, chunks of 2, the ring filling
  and wrapping before rho may change, against the JAX package's
  ``btd_step_kernel`` (the Pallas kernel in interpret mode) in float64:
  iterates to atol 1e-9, the nine stats rows to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel_btd import btd_step_kernel as jax_btd_step
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
from sqp_solver_tpu_torch.qp.types import QPSettings
from sqp_solver_tpu_torch.testing import btd_step_inputs
from sqp_solver_tpu_torch.tools import kernel_ab as ka

MAX_SMEM = 232448  # a block's shared memory on sm_90
SMEM_PER_SM = 233472
MEMORIES = (33, 40, 64, 65, 128)


def _blocks(smem_bytes):
    return SMEM_PER_SM // (smem_bytes + 1024)


def _gram(k):  # the Gram area: the kept Gram and the system by rows, rounded to 4
    return -(-(k * k + k * (k + 1)) // 4) * 4


def _solve(k):  # a solve area: k + 1 columns of k rows padded to 8 and 4 more, a head of 4
    return 4 + (((k + 7) // 8) * 8 + 4) * (k + 1)


# (kernel, n, m, bb, cluster, blocks an SM of the kernel without Anderson on
# an H100, its rows of A a block and shared-memory bytes, and at each of
# MEMORIES where the Gram area and the system go).  K6 on the MPC at horizon
# 64: 11,505 fixed floats and all 160 of a block's rows (193 floats each),
# 169,540 bytes, one block an SM; the Gram area and a solve area both fit in
# the 62,908 bytes left at 33-65 (at 65: 8,516 + 5,020 floats, 223,684
# bytes), at 128 neither (32,896 or 17,032 floats).  K7 on the NLP step at
# horizon 32: 89,156 bytes and two blocks an SM, which a block keeps up to
# 115,712 bytes: both at 33 and 40 (109,348 bytes at 40), at 64 and 65 the
# Gram area and a solve area together would take 139,876 / 143,300 bytes,
# so the solve area alone (106,852 / 109,236), at 128 neither.
NARROW = [
    ("K6", 192, 320, 8, 2, 1, 160, 169540,
     (("on", "scope"),) * 4 + (("off", "workspace"),)),
    ("K7", 128, 224, 8, 2, 2, 112, 89156,
     (("on", "scope"),) * 2 + (("off", "scope"),) * 2 + (("off", "workspace"),)),
]


@pytest.mark.parametrize("kernel,n,m,bb,cluster,twin_blocks,rows,twin_smem,want", NARROW,
                         ids=[s[0] for s in NARROW])
def test_narrow_structured_placement_past_32(kernel, n, m, bb, cluster, twin_blocks, rows,
                                              twin_smem, want):
    """Where K6's and K7's Gram area and chunk system go at MEMORIES, the
    block's shared memory the twin's plus the areas on chip, its rows of A
    the twin's, its blocks an SM no fewer."""
    for k, (gram, solve) in zip(MEMORIES, want):
        p = qk.anderson_placement(kernel, n, m, k, twin_blocks=twin_blocks, bb=bb,
                                  cluster=cluster)
        assert (p["gram"], p["solve"]) == (gram == "on", solve), (kernel, k, p)
        assert p["ring"] is False
        assert p["twin_rows"] == p["rows"] == rows and p["twin_smem_bytes"] == twin_smem
        sys = _solve(k) if solve == "scope" else 0
        assert p["solve_floats"] == sys
        assert p["smem_bytes"] == twin_smem + 4 * ((_gram(k) if p["gram"] else 0) + sys)
        assert p["smem_bytes"] <= MAX_SMEM and _blocks(p["smem_bytes"]) >= twin_blocks


def _wide_layouts(shared, smem_bytes, slack):
    """A wide layout by the floats reserved: the arrays ``shared`` while the
    reserve fits the ``slack`` floats that shared memory has left, the last
    of them to the workspace past it (first-fit)."""

    def layout(reserve):
        if reserve <= slack:
            return dict(shared=list(shared), smem_bytes=smem_bytes + 4 * reserve)
        return dict(shared=list(shared[:-1]), smem_bytes=smem_bytes)

    return layout


# The wide kernel at leg G's shapes (qp_kernel_btd_wide.cu:wide_layout, a
# cluster of two): the wide K6 on random bands n = 256, m = 384, bb = 64
# holds L^-1, the couplings, A's band rows and S in 222,624 bytes with 2,456
# floats left, so a solve area fits up to memory 40 (1,808 floats), the
# Gram area beside it never (3,240 + 1,808 at 40); the wide K7 at the
# NLP's block-64 shape (n = 128, m = 224) holds every array in 187,344
# bytes with 11,276 floats left: both up to 40 (5,048 floats), at 64 and 65
# the solve area alone (4,424 / 5,020; with the Gram area 12,680 / 13,536),
# at 128 neither.  One block an SM throughout.
WIDE = [
    ("wide K6", _wide_layouts(("Li", "GH", "A", "S"), 222624, 2456),
     (("off", "scope"),) * 2 + (("off", "workspace"),) * 3),
    ("wide K7", _wide_layouts(("Li", "GH", "A", "S", "F_prev", "F", "pd", "pe"), 187344, 11276),
     (("on", "scope"),) * 2 + (("off", "scope"),) * 2 + (("off", "workspace"),)),
]


@pytest.mark.parametrize("label,layout,want", WIDE, ids=[s[0] for s in WIDE])
def test_wide_placement_past_32(label, layout, want):
    """Where the wide kernel's Gram area and chunk system go at MEMORIES,
    given its layouts by the floats reserved; where any reserve loses an
    array (or the layout is refused) both areas stay off chip."""
    plain = layout(0)
    for k, (gram, solve) in zip(MEMORIES, want):
        p = qk.anderson_placement("wide", 256, 384, k, twin_blocks=None, bb=64, wide=layout)
        assert (p["gram"], p["solve"], p["ring"]) == (gram == "on", solve, False), (label, k)
        assert p["solve_floats"] == (_solve(k) if solve == "scope" else 0)
        reserve = (_gram(k) if p["gram"] else 0) + p["solve_floats"]
        assert layout(reserve)["shared"] == plain["shared"]
    for lost in (dict(plain, shared=plain["shared"][:-1]), None):
        p = qk.anderson_placement("wide", 256, 384, 40, twin_blocks=None, bb=64,
                                  wide=lambda r, lost=lost: lost if r else plain)
        assert (p["gram"], p["solve"], p["solve_floats"]) == (False, "workspace", 0)
    p = qk.anderson_placement("wide", 256, 384, 32, twin_blocks=None, bb=64)
    assert (p["gram"], p["solve"], p["solve_floats"]) == (True, "gram", 0)


@pytest.mark.parametrize("kernel,n,m,bb,cluster,twin_blocks",
                         [s[:6] for s in NARROW] + [("K6", 192, 320, 8, 1, 1),
                                                    ("K6", 32, 24, 8, 1, 4)],
                         ids=["K6", "K7", "K6-one-block", "K6-small"])
def test_no_memory_refused_nor_costing_the_twin(kernel, n, m, bb, cluster, twin_blocks):
    """Every memory from 1 to 5,000 gets a placement within the card's
    shared memory; past 32 the block keeps the twin's rows of A and blocks
    an SM whatever it holds on chip (K6 on one block, whose rows of A fill
    shared memory, keeps nothing there), the system in the workspace only
    where no solve area fits (at 5,000 one would take 100 MB)."""
    for k in list(range(1, 400, 13)) + [1000, 5000]:
        p = qk.anderson_placement(kernel, n, m, k, twin_blocks=twin_blocks, bb=bb,
                                  cluster=cluster)
        assert p["smem_bytes"] <= MAX_SMEM, (k, p)
        if k <= qk.AA_GRAM_SMEM_MEMORY:
            assert p["gram"] and p["solve"] == "gram"
            continue
        assert p["solve"] in ("scope", "workspace")
        assert p["rows"] == p["twin_rows"] and _blocks(p["smem_bytes"]) >= twin_blocks
        if p["solve"] == "workspace" and not p["gram"]:
            assert p["smem_bytes"] == p["twin_smem_bytes"]
    assert qk.anderson_placement(kernel, n, m, 5000, twin_blocks=twin_blocks, bb=bb,
                                 cluster=cluster)["solve"] == "workspace"
    one = qk.anderson_placement("K6", 192, 320, 40, twin_blocks=1, bb=8, cluster=1)
    assert (one["gram"], one["solve"], one["smem_bytes"]) == (False, "workspace",
                                                              one["twin_smem_bytes"])


def test_wide_no_memory_costs_an_array():
    """The wide kernel past 32 reserves on chip only what keeps its arrays
    in shared memory, at every memory to 5,000, at both leg G shapes."""
    for label, layout, _ in WIDE:
        plain = layout(0)
        for k in list(range(33, 400, 7)) + [1000, 5000]:
            p = qk.anderson_placement("wide", 256, 384, k, twin_blocks=None, bb=64, wide=layout)
            reserve = (_gram(k) if p["gram"] else 0) + p["solve_floats"]
            assert layout(reserve)["shared"] == plain["shared"], (label, k)


def test_second_units_build_beside_the_anderson_units():
    """The structured Anderson units' second units (the kernels whose step
    solves off the Gram area) exist, and this tree's libraries of those
    units hold them beside the unit each includes; a tree without them (a
    parent's) builds without."""
    from pathlib import Path

    csrc = Path(ka.ROOT) / "sqp_solver_tpu_torch" / "csrc"
    for src, second in ka.SYS_UNITS.items():
        assert (csrc / second).exists() and src in ka.TWINS
        assert ka.tree_units(ka.ROOT, [src]) == sorted([src, ka.TWINS[src], second])
        assert ka.tree_units(Path("/nonexistent"), [src]) == sorted([src, ka.TWINS[src]])
    for label, (p, g) in ka.FORCED_BTD.items():
        assert p in (0, 1, 3) and g in (0, 1)
    assert {ka.SOURCES[k] for k in ("k6xaa", "k7waa")} == {"qp_kernel_btd_wide_aa.cu"}


def _jax_step(t, settings):
    msk = np.zeros((8, t["g"].shape[0]))
    msk[2] = t["active"]
    msk[3] = t["rho_in"]
    args = [interop.band_to_kernel_layout(torch.as_tensor(t[k])) for k in ("pd", "pe")]
    args += [np.moveaxis(t[k], 0, -1) for k in ("J", "g", "l", "u")]
    args += [msk] + [np.moveaxis(t[k], 0, -1) for k in ("x", "z", "y")]
    p, z, y, st = jax_btd_step(*(jnp.asarray(v) for v in args), JaxQPSettings(**settings))
    return np.asarray(p).T, np.asarray(z).T, np.asarray(y).T, np.asarray(st)


@pytest.mark.parametrize("memory", [40, 65])
def test_plain_k7_past_32_matches_jax(memory):
    """K7 at T = 2 blocks of 8 (three problems, a carried rho on the second,
    the third inactive) with Anderson at ``memory`` in chunks of 2 for 150
    iterations, a fixed rho and eps 1e-30 so that no active problem stops:
    the ring fills at the (memory + 1)-th chunk and wraps, and is never
    emptied.  The port's plain K7 against the JAX kernel in float64."""
    t = btd_step_inputs(3, 2, 8, 12, seed=memory)
    s = dict(alpha=1.6, eps_abs=1e-30, eps_rel=1e-30, max_iter=150, check_termination=2,
             adaptive_rho=False, schedule="fixed",
             linear_solver="schur_block_tridiag", block_size=8, acceleration="anderson",
             anderson_memory=memory)
    jp, jz, jy, st = _jax_step(t, s)
    tt = {k: torch.as_tensor(v) for k, v in t.items()}
    out = qb.btd_step_kernel(tt["pd"], tt["pe"], tt["J"], tt["g"], tt["l"], tt["u"],
                             tt["active"], tt["x"], tt["z"], tt["y"], QPSettings(**s),
                             rho_in=tt["rho_in"])
    for name, a, b in (("p", out.x, jp), ("z", out.z, jz), ("y", out.y, jy)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-9, rtol=0, err_msg=name)
    rows = (out.done, out.iter, out.res_prim, out.res_dual, out.fail, out.rho_updates,
            out.rho_estimate, out.infs, out.rho_factor)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r.double().numpy(), st[i], rtol=1e-6, atol=1e-12,
                                   err_msg=f"stats row {i}")
    active = t["active"].astype(bool)
    assert (out.iter.numpy()[active] >= 2 * (memory + 2)).all()
    assert int(out.iter[-1]) == 0
