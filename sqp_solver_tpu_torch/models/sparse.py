"""Arbitrary-unstructured-sparsity QP family (twin of
``sqp_solver_tpu/models/sparse.py``): a random block pattern with no band
or border, the case the structured backends cannot express, for the
BlockSparse operands on the matrix-free ``cg`` backend.  The data are
drawn with the same numpy calls in the same order as the JAX package, so
one seed gives the identical problem in both.
"""

from __future__ import annotations

import numpy as np
import torch

from sqp_solver_tpu_torch.ops.block_sparse import from_dense
from sqp_solver_tpu_torch.qp.types import QuadraticProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = ["sparse_qp_pair"]


def sparse_qp_pair(
    n: int = 2048,
    m: int = 2048,
    bs: int = 128,
    density: float = 0.05,
    seed: int = 0,
    dtype=torch.float32,
    pattern_seed: int | None = None,
    device=None,
):
    """A random block-sparse strictly convex QP as ``(dense, sparse)``
    twins of the same problem, one problem without the batch axis
    (``sparse`` carries BlockSparse P and A and the same q, l, u), on
    ``device`` (by default the card).

    P: a symmetric random block pattern at ``density`` (diagonal blocks
    always present), strictly positive definite by diagonal dominance.  A:
    a random block pattern at ``density``, at least one block a block row.
    The bounds are finite and feasible.  The block pattern comes from
    ``pattern_seed`` (by default ``seed``) and the values from ``seed``."""
    dev = resolve_device(device)
    prng = np.random.default_rng(seed if pattern_seed is None else pattern_seed)
    rng = np.random.default_rng(seed)
    Rb = Cb = n // bs
    Mb = m // bs

    P = np.zeros((n, n), np.float64)
    for i in range(Rb):
        for j in range(i + 1):
            if i != j and prng.uniform() > density:
                continue
            P[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.normal(size=(bs, bs)) / np.sqrt(n)
    P = 0.5 * (P + P.T)
    P[np.arange(n), np.arange(n)] += np.abs(P).sum(axis=1) + 0.1

    A = np.zeros((m, n), np.float64)
    for i in range(Mb):
        cols = np.nonzero(prng.uniform(size=Cb) < density)[0]
        if len(cols) == 0:
            cols = [int(prng.integers(Cb))]
        for j in cols:
            A[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = (rng.normal(size=(bs, bs))
                                                           / np.sqrt(bs * len(cols)))

    q = rng.normal(size=n)
    Ax = A @ rng.normal(size=n)
    width = rng.uniform(0.5, 2.0, size=m)

    def t(a):
        return torch.as_tensor(a).to(dtype=dtype, device=dev)

    dense = QuadraticProblem(P=t(P), q=t(q), A=t(A), l=t(Ax - width), u=t(Ax + width))
    sparse = QuadraticProblem(P=from_dense(dense.P, bs), q=dense.q, A=from_dense(dense.A, bs),
                              l=dense.l, u=dense.u)
    return dense, sparse
