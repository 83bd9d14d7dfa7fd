"""Block-sparse matrices for arbitrary unstructured sparsity (twin of
``sqp_solver_tpu/ops/block_sparse.py``).

The matrix is a static grid of ``bs x bs`` tiles of which only the nonzero
ones are stored.  The JAX package computes these operations with plain
XLA, so here they are plain PyTorch: no kernel.  Every product is the
*strip* formulation: per output block row, the (up to) K stored tiles
that feed it are laid side by side into one dense (K bs, bs) strip, the
input blocks they multiply are gathered with a static index map, and the
whole product is one batched contraction.  The pattern (``rows``,
``cols``, ``shape``, ``bs``) is plain Python data, fixed per instance;
``data`` is a tensor of the stored tiles, (nb, bs, bs), or (B, nb, bs, bs)
for a batch of matrices that share the pattern.  Products take vectors
with the same optional leading batch.

The solvers take a BlockSparse P or A on the matrix-free ``cg`` backend
(:mod:`sqp_solver_tpu_torch.ops.linear_solver`), which forms no Gram and no
factor, so the pattern never fills in.
"""

from __future__ import annotations

import numpy as np
import torch

from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = ["BlockSparse", "from_dense", "to_dense"]


class BlockSparse:
    """Block-sparse matrix: ``data[..., k, :, :]`` is the dense (bs, bs)
    tile at block position (``rows[k]``, ``cols[k]``).  ``shape`` is the
    dense shape of one matrix; both dimensions are multiples of ``bs``."""

    def __init__(self, data: torch.Tensor, rows, cols, shape, bs: int):
        self.data = data
        self.rows = tuple(int(r) for r in rows)
        self.cols = tuple(int(c) for c in cols)
        self.shape = (int(shape[0]), int(shape[1]))
        self.bs = int(bs)
        self._plans = {}

    @property
    def nblocks(self) -> int:
        return len(self.rows)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def with_data(self, data: torch.Tensor) -> "BlockSparse":
        """The same pattern (and its cached strip plans) over other tiles."""
        out = BlockSparse(data, self.rows, self.cols, self.shape, self.bs)
        out._plans = self._plans
        return out

    def __getitem__(self, idx) -> "BlockSparse":
        """The matrices ``idx`` of a batch (indexing the leading axis)."""
        if self.data.dim() != 4:
            raise IndexError("indexing a BlockSparse needs a batch axis on its data")
        return self.with_data(self.data[idx])

    def _plan(self, transpose: bool):
        """The strip plan of the product by M (or M'): (idxmap, srcmap), each
        (n_out, K) index tensors on the data's device.  idxmap[r, k] is the
        tile laid at slot k of output block row r (``nblocks``: the zero pad
        tile), srcmap[r, k] the input block it multiplies.  Cached."""
        key = (transpose, str(self.data.device))
        hit = self._plans.get(key)
        if hit is not None:
            return hit
        outs = self.cols if transpose else self.rows
        srcs = self.rows if transpose else self.cols
        n_out = (self.shape[1] if transpose else self.shape[0]) // self.bs
        per = {}
        for k, (o, s) in enumerate(zip(outs, srcs)):
            per.setdefault(o, []).append((k, s))
        K = max((len(v) for v in per.values()), default=1)
        idxmap = np.full((n_out, K), self.nblocks, np.int64)
        srcmap = np.zeros((n_out, K), np.int64)
        for o, lst in per.items():
            for j, (k, s) in enumerate(lst):
                idxmap[o, j] = k
                srcmap[o, j] = s
        plan = tuple(torch.as_tensor(a, device=self.data.device) for a in (idxmap, srcmap))
        self._plans[key] = plan
        return plan

    def prepare(self, transpose: bool = False) -> torch.Tensor:
        """The strip array (..., n_out, K bs, bs) of the product by M
        (``transpose=False``) or M'.  A loop that multiplies many times (the
        ``cg`` backend) builds it once and passes it back as ``prepared``."""
        idxmap, _ = self._plan(transpose)
        n_out, K = idxmap.shape
        lead = self.data.shape[:-3]
        pad = self.data.new_zeros(lead + (1, self.bs, self.bs))
        data_p = torch.cat([self.data, pad], dim=-3)
        tiles = data_p.index_select(data_p.dim() - 3, idxmap.reshape(-1))
        tiles = tiles.reshape(lead + (n_out, K, self.bs, self.bs))
        if not transpose:
            # y_i = sum_j M_ij x_j: lay each tile as [j, i] so that both
            # products contract over the strip's middle axis
            tiles = tiles.transpose(-1, -2)
        return tiles.reshape(lead + (n_out, K * self.bs, self.bs))

    def _apply(self, v: torch.Tensor, transpose: bool, prepared=None) -> torch.Tensor:
        _, srcmap = self._plan(transpose)
        n_out, K = srcmap.shape
        n_in = (self.shape[0] if transpose else self.shape[1]) // self.bs
        strips = self.prepare(transpose) if prepared is None else prepared
        vb = v.reshape(v.shape[:-1] + (n_in, self.bs))
        vb = vb.index_select(vb.dim() - 2, srcmap.reshape(-1))
        vb = vb.reshape(v.shape[:-1] + (n_out, K * self.bs))
        out = torch.matmul(vb.unsqueeze(-2), strips).squeeze(-2)
        return out.reshape(out.shape[:-2] + (n_out * self.bs,))

    def mv(self, x: torch.Tensor, prepared=None) -> torch.Tensor:
        """M x for x (..., n): one gather and one batched strip contraction."""
        return self._apply(x, False, prepared)

    def rmv(self, y: torch.Tensor, prepared=None) -> torch.Tensor:
        """M' y for y (..., m), from strips built per block column."""
        return self._apply(y, True, prepared)

    def scaled_gram_mv(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(M' diag(w) M) x without forming the Gram."""
        return self.rmv(w * self.mv(x))

    def diag(self) -> torch.Tensor:
        """The dense diagonal (..., n) of a square M."""
        if self.shape[0] != self.shape[1]:
            raise ValueError(f"diag of a non-square BlockSparse {self.shape}")
        nr = self.shape[0] // self.bs
        lead = self.data.shape[:-3]
        out = self.data.new_zeros(lead + (nr, self.bs))
        on = [k for k, (r, c) in enumerate(zip(self.rows, self.cols)) if r == c]
        if on:
            dev = self.data.device
            d = torch.diagonal(self.data[..., on, :, :], dim1=-2, dim2=-1)
            rows = torch.as_tensor([self.rows[k] for k in on], device=dev)
            out = out.index_add(out.dim() - 2, rows, d)
        return out.reshape(lead + (nr * self.bs,))


def from_dense(M, bs: int = 128, tol: float = 0.0, pad: bool = False, dtype=None,
               device=None) -> BlockSparse:
    """The BlockSparse of a dense matrix (n_r, n_c): the tiles whose largest
    magnitude exceeds ``tol`` are stored.  ``M`` is a numpy array or a
    tensor; the tiles take ``dtype`` (by default M's) and ``device`` (by
    default a tensor's own, the card for an array).

    Both dimensions must be multiples of ``bs``, since the solvers size q,
    l and u from the operator's shape; ``pad=True`` zero-pads instead, and
    the caller pads the QP's vectors to the returned ``shape``."""
    if isinstance(M, torch.Tensor):
        device = M.device if device is None else device
        dtype = M.dtype if dtype is None else dtype
        M = M.detach().cpu().numpy()
    M = np.asarray(M)
    nr, nc = M.shape
    if nr % bs or nc % bs:
        if not pad:
            raise ValueError(
                f"from_dense: shape {M.shape} is not a multiple of bs={bs}; pad the "
                "matrix (and the QP's q/l/u) yourself or pass pad=True and pad the "
                "vectors to the returned .shape"
            )
        M = np.pad(M, ((0, (-nr) % bs), (0, (-nc) % bs)))
        nr, nc = M.shape
    tiles = M.reshape(nr // bs, bs, nc // bs, bs)
    norms = np.abs(tiles).max(axis=(1, 3))
    rows, cols = np.nonzero(norms > tol)
    if len(rows) == 0:  # keep one tile so that the shapes stay non-degenerate
        rows, cols = np.asarray([0]), np.asarray([0])
    data = torch.as_tensor(np.stack([tiles[r, :, c, :] for r, c in zip(rows, cols)]))
    data = data.to(dtype=data.dtype if dtype is None else dtype, device=resolve_device(device))
    return BlockSparse(data, rows, cols, (nr, nc), bs)


def to_dense(S: BlockSparse) -> torch.Tensor:
    """The dense matrix (..., n_r, n_c) of a BlockSparse."""
    lead = S.data.shape[:-3]
    out = S.data.new_zeros(lead + S.shape)
    bs = S.bs
    for k, (r, c) in enumerate(zip(S.rows, S.cols)):
        out[..., r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += S.data[..., k, :, :]
    return out
