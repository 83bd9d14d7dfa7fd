"""The Anderson step of the CUDA kernels (``csrc/admm_core.cuh:aa_chunk_end``)
on the CPU: where its state lives, and the Gram it keeps from chunk to chunk.

* The placement rule through its Python mirror
  (``ops/qp_kernel.py:anderson_placement``) at the shapes of ``chip_smoke.py``'s
  leg G and the card tests: the Gram in shared memory at every memory up to
  32, the ring there where it costs the kernel without Anderson nothing (no
  matrix or row of A leaves shared memory, no block an SM is lost), else in
  the workspace; the wide kernel's ring in the workspace; past memory 32 the
  Gram area too in shared memory only where it costs nothing, else in the
  workspace; a memory below 1 refused.
* A numpy mirror of the kept Gram in float64: a ring of k slots, each chunk
  pushing one pair into the oldest slot and computing only that pair's row of
  the Gram and the right-hand side, over a dozen chunks with evictions and a
  rho reset.  At every chunk the kept Gram equals the Gram rebuilt from
  scratch, and the candidate from its normal equations (the kernel's order:
  Levenberg term, identity on the unused rows, Gauss-Jordan) equals at 1e-12
  the ``u_aa`` of the JAX package's ``qp/anderson.py:anderson_extrapolate`` on
  the same chunks (the same scheme as the in-kernel ``aa_step``, which sits
  inside the Pallas body).
"""

from __future__ import annotations

import numpy as np
import pytest

from sqp_solver_tpu_torch.ops import qp_kernel as qk

# ---------------------------------------------------------------------------
# the placement rule's mirror
# ---------------------------------------------------------------------------

# (kernel, n, m, bb, cluster, blocks an SM of the kernel without Anderson,
# ring on chip): leg G's shapes (K1 n = 32, K3 random n = 32, m = 33 in both
# layouts, K6 MPC horizon 64 and K7 NLP step horizon 32 on clusters, the
# wide kernel at bb = 64), K1 at n = 128, and K6 at horizon 64 on one block,
# where A's rows fill shared memory.  The blocks an SM are the runtime's on
# an H100 (cudaOccupancyMaxActiveBlocksPerMultiprocessor, as
# anderson_placement_card reports them; the card test holds the launchers
# to the mirror with the card's own).
LEG_SHAPES = [
    ("K1", 32, 33, None, None, 8, True),
    ("K1", 128, 129, None, None, 1, True),
    ("K3-warp", 32, 33, None, None, 8, False),
    ("K3-block", 32, 33, None, None, 8, True),
    ("K6", 192, 320, 8, 2, 1, True),
    ("K7", 128, 224, 8, 2, 2, True),
    ("K6", 192, 320, 8, 1, 1, False),
    ("wide", 256, 384, 64, 2, None, False),
]


@pytest.mark.parametrize("kernel,n,m,bb,cluster,twin_blocks,ring", LEG_SHAPES,
                         ids=[f"{s[0]}-n{s[1]}-cs{s[4]}" for s in LEG_SHAPES])
def test_placement_rule_at_the_legs_shapes(kernel, n, m, bb, cluster, twin_blocks, ring):
    """The ring where the rule puts it at memory 4; the Gram area k^2 +
    k (k + 1) floats (rounded to 4) always; with the ring on chip, shared
    memory still holds what the kernel without Anderson holds and allows as
    many blocks an SM as it gets; off chip, the block takes only the Gram
    area more (where A's rows fill shared memory, it may take the room of the
    last row the kernel without Anderson holds)."""
    p = qk.anderson_placement(kernel, n, m, 4, twin_blocks=twin_blocks, bb=bb, cluster=cluster)
    assert p["ring"] is ring
    assert p["gram_floats"] == 36
    rows = m if kernel.startswith(("K1", "K3")) else -(-m // (cluster or 2))
    assert p["ring_floats"] == 12 * (n + 2 * rows)
    if kernel == "wide":
        return
    assert p["smem_bytes"] <= 232448
    extra = 4 * (p["gram_floats"] + (p["ring_floats"] if ring else 0))
    if kernel in ("K1", "K3-block"):
        assert p["mats"] == p["twin_mats"]
        assert p["smem_bytes"] == p["twin_smem_bytes"] + extra
    elif kernel == "K3-warp":
        assert p["smem_bytes"] == p["twin_smem_bytes"] + 2 * extra
    else:
        # where A's rows fill shared memory the Gram may take the last one's room
        assert p["rows"] in (p["twin_rows"], p["twin_rows"] - 1)
        assert p["rows"] == p["twin_rows"] or p["twin_rows"] < -(-m // cluster)
    if ring:
        assert 233472 // (p["smem_bytes"] + 1024) >= p["twin_blocks"]


@pytest.mark.parametrize("k", [1, 8, 32])
def test_placement_rule_across_memories(k):
    """A longer memory takes a larger ring: at K1 n = 32 the ring stays on
    chip up to the memory at which shared memory would allow fewer blocks
    an SM than the kernel without Anderson gets, and moves off chip past it
    (twin_blocks given, as the card's runtime reports it)."""
    on = qk.anderson_placement("K1", 32, 33, k, twin_blocks=8)
    with_ring = on["twin_smem_bytes"] + 4 * (on["gram_floats"] + on["ring_floats"])
    assert on["ring"] is (233472 // (with_ring + 1024) >= 8)
    assert on["gram_floats"] == -(-(k * k + k * (k + 1)) // 4) * 4


# (kernel, n, m, bb, cluster, blocks an SM of the kernel without Anderson,
# the Gram area in shared memory at memories 33, 48 and 64): past memory 32
# every kernel's chunk system leaves the Gram area for a solve area, which
# beat the whole area on chip on the card; K1's and K3's Gram area never
# stays on chip (tests/test_torch_anderson_past32.py), K6's and K7's only
# where, with a solve area beside it, it keeps the twin's rows of A and
# blocks an SM (tests/test_torch_anderson_past32_btd.py).  K7 at the NLP
# step's shape up to 40, where with the solve area a block an SM would go
# next; K6 on a cluster always; K6 on one block, whose A rows fill shared
# memory, never; K6 at n = 32, m = 24 up to 48, with its ring beside it at 33
PAST_32 = [
    ("K1", 32, 33, None, None, 8, (False, False, False)),
    ("K1", 128, 129, None, None, 1, (False, False, False)),
    ("K3-warp", 32, 33, None, None, 8, (False, False, False)),
    ("K3-block", 32, 33, None, None, 8, (False, False, False)),
    ("K6", 192, 320, 8, 2, 1, (True, True, True)),
    ("K6", 192, 320, 8, 1, 1, (False, False, False)),
    ("K7", 128, 224, 8, 2, 2, (True, False, False)),
    ("K6", 32, 24, 8, 1, 4, (True, True, False)),
]


def test_placement_rule_refuses_past_the_bound():
    """Memory 0 raises a ValueError for every kernel; past memory 32 (the
    kernels' bound before the Gram area could leave shared memory) every
    kernel gives a placement: at 33, 48 and 64 the Gram area stays in shared
    memory exactly where, with it (and K6's and K7's solve area), the block
    still holds what the kernel without Anderson holds and gets as many
    blocks an SM (K1 and K3: never, PAST_32), else it leaves
    (``gram`` False, the block's shared memory that of the kernel without
    Anderson and, for K1 and K3, the solve areas of the chunk's system,
    ``solve_floats``); the ring is on chip only beside it."""
    for kernel in qk.ANDERSON_KERNELS:
        with pytest.raises(ValueError, match="anderson_memory"):
            qk.anderson_placement(kernel, 32, 48, 0, twin_blocks=1, bb=8, cluster=2)
    for kernel, n, m, bb, cluster, twin, want in PAST_32:
        for k, on in zip((33, 48, 64), want):
            p = qk.anderson_placement(kernel, n, m, k, twin_blocks=twin, bb=bb, cluster=cluster)
            assert p["gram"] is on, (kernel, n, m, cluster, k, p)
            assert p["gram_floats"] == -(-(k * k + k * (k + 1)) // 4) * 4
            assert not p["ring"] or p["gram"]
            scopes = 2 if kernel == "K3-warp" else 1
            extra = 4 * scopes * ((p["gram_floats"] if on else 0)
                                  + (p["ring_floats"] if p["ring"] else 0))
            extra += 4 * p.get("solve_floats", 0)
            assert p["smem_bytes"] <= 232448
            if kernel in ("K1", "K3-block"):
                assert p["mats"] == p["twin_mats"]
            if kernel in ("K6", "K7"):
                assert p["rows"] == p["twin_rows"]
            assert p["smem_bytes"] == p["twin_smem_bytes"] + extra
            if on:
                assert 233472 // (p["smem_bytes"] + 1024) >= twin
    # the wide kernel, given its layouts without Anderson and with its
    # areas reserved (here the same whatever the reserve): on chip where the
    # reserve moves no array and no block an SM
    plain = dict(shared=["Li", "GH", "A"], smem_bytes=150000)
    for reserved, on in ((dict(shared=["Li", "GH", "A"], smem_bytes=163000), True),
                         (dict(shared=["Li", "A"], smem_bytes=150000), False),
                         (dict(shared=["Li", "GH", "A"], smem_bytes=232000), True),
                         (None, False)):
        p = qk.anderson_placement("wide", 272, 160, 40, twin_blocks=None, bb=136,
                                  wide=lambda r, reserved=reserved: reserved if r else plain)
        assert p["gram"] is on and p["ring"] is False
    assert qk.anderson_placement("wide", 272, 160, 32, twin_blocks=None, bb=136)["gram"]
    small = dict(shared=["Li"], smem_bytes=30000)
    p = qk.anderson_placement("wide", 512, 200, 40, twin_blocks=None, bb=256,
                              wide=lambda r: dict(shared=["Li"], smem_bytes=43000) if r else small)
    assert p["gram"] is False  # 7 blocks an SM by shared memory would drop to 5


# ---------------------------------------------------------------------------
# the kept Gram
# ---------------------------------------------------------------------------


class KeptGram:
    """A float64 mirror of one scope's Anderson state in the kernels: the
    difference pairs in a ring of k slots (slot ``head`` the oldest), the
    Gram of the pairs' dF by slot, kept from chunk to chunk."""

    def __init__(self, k: int, D: int):
        self.k, self.D = k, D
        self.dU = np.zeros((k, D))
        self.dF = np.zeros((k, D))
        self.Gk = np.full((k, k), np.nan)  # an entry is written before it is read
        self.uT = np.zeros(D)
        self.f = np.zeros(D)
        self.prev_ok, self.pairs, self.head = False, 0, 0

    def reset(self):
        """A rho change: the ring empties, and with it the kept entries."""
        self.prev_ok, self.pairs = False, 0

    def slot(self, a: int) -> int:
        return (self.head + a) % self.k

    def chunk(self, u_in, u_T):
        """One chunk's end: push the pair, compute the pushed row of the
        Gram and the right-hand side only, solve, return the candidate
        (None without pairs)."""
        k = self.k
        f = u_T - u_in
        push = self.head
        if self.prev_ok:
            self.dU[push] = u_T - self.uT
            self.dF[push] = f - self.f
            self.pairs = min(self.pairs + 1, k)
            self.head = (self.head + 1) % k
        self.uT, self.f, self.prev_ok = u_T.copy(), f.copy(), True
        if self.pairs == 0:
            return None
        lo = k - self.pairs
        valid = [self.slot(a) for a in range(lo, k)]
        for s in valid:
            self.Gk[push, s] = self.Gk[s, push] = self.dF[push] @ self.dF[s]
        rhs = np.array([self.dF[s] @ f for s in valid])
        G = np.zeros((k, k))
        G[lo:, lo:] = self.Gk[np.ix_(valid, valid)]
        reg = 1e-8 * (sum(G[a, a] for a in range(lo, k)) + 1.0)
        for a in range(k):
            G[a, a] += reg + (1.0 if a < lo else 0.0)
        aug = np.concatenate([G, np.zeros((k, 1))], axis=1)
        aug[lo:, k] = rhs
        for i in range(k):  # Gauss-Jordan in the kernels' order
            inv = 1.0 / aug[i, i]
            for r in range(k):
                if r != i:
                    aug[r] = aug[r] - aug[r, i] * (aug[i] * inv)
            aug[i] = aug[i] * inv
        gamma = aug[lo:, k]
        return u_T - gamma @ self.dU[valid]

    def fresh_gram(self):
        """The Gram of the pairs held, rebuilt from the ring in the logical
        order, each entry the dot product of its two pairs' dF."""
        valid = [self.slot(a) for a in range(self.k - self.pairs, self.k)]
        return np.array([[self.dF[a] @ self.dF[b] for b in valid] for a in valid]), valid


@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_kept_gram_equals_the_fresh_gram_and_jax(k):
    """A dozen chunks of a contracting affine map with noise (a rho reset at
    chunk 7): at every chunk the kept Gram equals the Gram rebuilt from
    scratch, every pair's entries are those of its own dF, and the candidate
    agrees at 1e-12 with the JAX package's anderson_extrapolate fed the same
    chunks (its state reset alike)."""
    import jax.numpy as jnp

    from sqp_solver_tpu.qp.anderson import anderson_extrapolate, anderson_init

    D = 11
    rng = np.random.default_rng(100 + k)
    M = 0.3 * rng.standard_normal((D, D)) / np.sqrt(D)
    c = rng.standard_normal(D)
    mirror = KeptGram(k, D)
    aa = anderson_init((), k, D, jnp.float64)
    u = rng.standard_normal(D)
    checked = 0
    for chunk in range(12):
        if chunk == 7:
            mirror.reset()
            aa = dict(aa, prev_ok=jnp.asarray(False), pairs=jnp.asarray(0, jnp.int32))
        u_T = M @ u + c + 1e-3 * rng.standard_normal(D)
        cand = mirror.chunk(u, u_T)
        u_aa, pairs, aa = anderson_extrapolate(aa, jnp.asarray(u), jnp.asarray(u_T), k)
        assert int(pairs) == mirror.pairs
        if cand is not None:
            fresh, valid = mirror.fresh_gram()
            np.testing.assert_array_equal(mirror.Gk[np.ix_(valid, valid)], fresh)
            np.testing.assert_allclose(cand, np.asarray(u_aa), rtol=0, atol=1e-12)
            checked += 1
        u = u_T if cand is None else cand
    assert checked == 10  # chunks 0 and 7 have no pairs
    assert mirror.pairs == min(k, 4)  # chunks 8-11 after the reset
