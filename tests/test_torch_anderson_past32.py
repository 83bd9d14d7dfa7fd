"""K1's and K3's Anderson step past memory 32 on the CPU: where the chunk's
system goes, and the plain K3 with Anderson at a memory whose solve takes
three rounds of 32 lanes.

Past memory 32 K1 and K3 keep the Gram area (the kept Gram and the chunk's
k x (k + 1) system) and the ring in the workspace, and put the system, which every pivot of the k x k solve reads and
writes, in a solve area of shared memory: one a problem where that keeps the
twin's blocks an SM, one a block (K3's warp layout: its two problems take it
in turn) where that does, else one a block wherever shared memory holds it,
and in the workspace only where it does not (``csrc/qp_kernel.cu:
aa_dense_plan``, its Python mirror ``ops/qp_kernel.py:anderson_placement``).

* The mirror at memories 33, 40, 64 and 128 for K1, K3's block layout and
  K3's warp layout at leg G's shapes: where the system goes, the shared
  memory it takes, and that no memory is refused (up to 5,000).
* The plain K3 with Anderson at memory 65 against the JAX package's
  ``qp_solve_batch(impl="kernel")`` in float64 (the Pallas kernel in
  interpret mode), warm-started, chunks of 2 and rho every 160 iterations,
  so that the ring fills and wraps before rho may change: statuses,
  iteration and rho-update counts equal, x, y, z within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sqp_solver_tpu.parallel.batch import qp_solve_batch as jax_qp_solve_batch
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QPState as JaxQPState
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu_torch import interop
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPSettings
from sqp_solver_tpu_torch.testing import qp_inputs

MAX_SMEM = 232448  # a block's shared memory on sm_90
SMEM_PER_SM = 233472
MEMORIES = (33, 40, 64, 128)

# (kernel, n, m, blocks an SM of the kernel without Anderson on an H100, as
# anderson_placement_card reports them; the card test holds the launchers to
# the mirror with the card's own), and where the chunk's system goes at each
# of MEMORIES: leg G's shapes (K1 n = 32; K3 random n = 32, m = 33 in both
# layouts), K1 at n = 128 (one block an SM) and K3's warp layout at n = 16
LEG_SHAPES = [
    ("K1", 32, 33, 8, ("scope", "scope", "scope", "scope")),
    ("K3-block", 32, 33, 8, ("scope", "scope", "scope", "scope")),
    ("K3-warp", 32, 33, 8, ("block", "block", "block", "block")),
    ("K1", 128, 129, 1, ("scope", "scope", "scope", "workspace")),
    ("K3-warp", 16, 24, 8, ("scope", "scope", "block", "block")),
]


def _blocks(smem_bytes):
    return SMEM_PER_SM // (smem_bytes + 1024)


@pytest.mark.parametrize("kernel,n,m,twin_blocks,want", LEG_SHAPES,
                         ids=[f"{s[0]}-n{s[1]}" for s in LEG_SHAPES])
def test_solve_area_placement(kernel, n, m, twin_blocks, want):
    """Where the chunk's system goes at memories 33, 40, 64 and 128 (``want``):
    past memory 32 the Gram area leaves shared memory, so the system is
    never beside it ("gram");
    else a solve area of the k x (k + 1) system by columns a problem
    ("scope") or a block ("block"), after a head of 4 floats (a block's
    lock word), whose floats the block's shared memory takes on top of the
    twin's; a solve area a problem
    only where it keeps the twin's blocks an SM, one a block on a layout of
    two problems only where one a problem does not; the twin's matrices in
    shared memory either way, and the block within the card's 227 KB."""
    scopes = 2 if kernel == "K3-warp" else 1
    for k, solve in zip(MEMORIES, want):
        p = qk.anderson_placement(kernel, n, m, k, twin_blocks=twin_blocks)
        assert p["solve"] == solve, (kernel, n, k, p)
        assert (solve == "gram") is p["gram"]
        area = (((k + 7) & ~7) + 4) * (k + 1)  # by columns, rows padded to 8 and 4 more
        assert p["solve_floats"] == {"gram": 0, "workspace": 0, "scope": 4 + scopes * area,
                                     "block": 4 + area}[solve]
        on_chip = scopes * ((p["gram_floats"] if p["gram"] else 0)
                            + (p["ring_floats"] if p["ring"] else 0))
        assert p["smem_bytes"] == p["twin_smem_bytes"] + 4 * (on_chip + p["solve_floats"])
        assert p["smem_bytes"] <= MAX_SMEM
        if kernel != "K3-warp":
            assert p["mats"] == p["twin_mats"] and p["workspace_floats"] == 0
        scope_bytes = p["twin_smem_bytes"] + 4 * (4 + scopes * area)
        if solve == "scope":
            assert scopes == 1 or _blocks(scope_bytes) >= twin_blocks
        if solve == "block":
            assert _blocks(scope_bytes) < twin_blocks


@pytest.mark.parametrize("kernel,n,m,twin_blocks", [s[:4] for s in LEG_SHAPES],
                         ids=[f"{s[0]}-n{s[1]}" for s in LEG_SHAPES])
def test_no_memory_refused(kernel, n, m, twin_blocks):
    """Every memory from 1 to 5,000 gets a placement within the card's
    shared memory: the Gram area on chip up to 32; past it the system in a
    solve area wherever one fits beside the twin's matrices, else in the
    workspace (at 5,000 a solve area would take 100 MB), the block then
    taking no more shared memory than the kernel without Anderson."""
    for k in list(range(1, 400, 13)) + [1000, 5000]:
        p = qk.anderson_placement(kernel, n, m, k, twin_blocks=twin_blocks)
        assert p["smem_bytes"] <= MAX_SMEM, (k, p)
        assert p["gram"] or k > qk.AA_GRAM_SMEM_MEMORY
        if p["solve"] == "workspace":
            assert p["smem_bytes"] == p["twin_smem_bytes"]
    assert qk.anderson_placement(kernel, n, m, 5000, twin_blocks=twin_blocks)["solve"] == (
        "workspace")
    with pytest.raises(ValueError, match="anderson_memory"):
        qk.anderson_placement(kernel, n, m, 0, twin_blocks=twin_blocks)


LEAVES = ("P", "q", "A", "l", "u")


def test_plain_k3_at_memory_65_matches_jax():
    """Two warm-started random QPs (n = 16, m = 24, a loose row) with
    Anderson at memory 65 in chunks of 2 for 170 iterations, rho every 160:
    the ring fills at the 66th chunk and wraps through the last 18, before
    rho may change.  The port's plain K3 (``qp_solve_batch(impl="kernel")``
    on the CPU) against the JAX package's kernel in float64."""
    a = qp_inputs(2, 16, 24, seed=65, loose_row=True)
    s = dict(alpha=1.6, eps_abs=1e-8, eps_rel=1e-8, max_iter=170, check_termination=2,
             adaptive_rho=True, adaptive_rho_interval=160, schedule="fixed",
             acceleration="anderson", anderson_memory=65)
    jst = JaxQPState(*(jnp.asarray(a[k]) for k in "xzy"))
    pst = interop.qp_state_from_numpy(a["x"], a["z"], a["y"], device="cpu")
    jr = jax_qp_solve_batch(JaxQP(*(jnp.asarray(a[k]) for k in LEAVES)), JaxQPSettings(**s),
                            state=jst, impl="kernel")
    pr = qp_solve_batch(interop.qp_from_arrays(*(a[k] for k in LEAVES), device="cpu"),
                        QPSettings(**s), state=pst, impl="kernel")
    p = interop.qp_result_to_numpy(pr)
    for k in ("status", "iter", "rho_updates"):
        np.testing.assert_array_equal(p[k], np.asarray(getattr(jr.info, k)), err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(p[k], np.asarray(getattr(jr, k)), atol=1e-9, rtol=0,
                                   err_msg=k)
    assert (p["iter"] >= 2 * (65 + 2)).all()
