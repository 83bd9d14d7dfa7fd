"""The block-tridiagonal whole-QP kernel (twin of
``sqp_solver_tpu/ops/qp_kernel_btd.py``) and its two entry points: the
structured QP solve (K6, :func:`qp_solve_kernel_btd`) and the structured
SQP step (K7, :func:`btd_step_kernel`).

For stage-wise problems the Schur matrix M = P + sigma I + A' diag(rho) A
is block-tridiagonal.  The solve runs the same ADMM core as the dense
whole-QP kernel (``ops/qp_kernel.py:_admm_core``) through its structured
hooks:

    factor:  the Gram band (A' rho A)_{k,k}, (A' rho A)_{k+1,k} from A's
             columns, then block-Thomas Cholesky
             S_k = D_k - F_{k-1} F_{k-1}',  L_k = chol(S_k),
             F_k = E_k L_k^-T  (F_{T-1} = 0),
             and the sweeps' couplings G_k = L_k^-1 F_{k-1},
             H_k = L_k^-T F_k'                          O(T bb^3 + m n bb)
    M^-1 b:  c_k = L_k^-1 b_k (all k), w_k = c_k - G_k w_{k-1},
             d_k = L_k^-T w_k (all k), x_k = d_k - H_k x_{k+1}   O(n bb)
    P v:     from the band of P only

Entries of M outside the band are ignored: the caller guarantees the
structure.  ``bb = btd_internal_block(block_size)`` fixes which entries are
read; it is a semantic of the solver (and the block size of the structured
SQP tier's BFGS), not a layout choice.  The band holds M exactly where every
row of A touches at most two consecutive column blocks; there the wide
route keeps A in two-block band rows (:func:`band_rows`), each row's 2 bb
entries from its first nonzero column block (at most T - 2), and its
matvecs and Gram band read only those; a problem with a row outside two
consecutive blocks reads A densely.

Each entry point has a plain PyTorch version (:func:`qp_btd_reference`,
batched tensor code that follows the kernel's per-problem algorithm, with
the column Cholesky's pivot clamp and fail rule) and a wrapper that sends
CPU tensors to it and CUDA tensors to a CUDA kernel: internal blocks 8, 16,
24 and 32 to ``csrc/qp_kernel_btd.cu`` (one thread block per problem, or a
cluster of two where one block cannot hold A in shared memory), every other
multiple of 8 to ``csrc/qp_kernel_btd_wide.cu`` (a cluster of two blocks
per problem, A in band rows and the band and factor arrays split over the
cluster's shared memory, the arrays it cannot hold in a device workspace;
:func:`wide_layout`; past :data:`COMPACT_ABOVE`, as for the OSQP control
class at 50 states, its compact route: A's band rows held by their
nonzeros, :func:`compact_rows`, each matrix of the sweeps in a slot of one
block, in a cluster of 2, 4 or 8 that the layout rule picks for the
nonzeros a block holds, :func:`compact_nnz`).
The one shape the card refuses is one whose vectors and fixed part do not
fit a cluster block's shared memory (:func:`wide_layout` returns None).
On the CPU the wide route's plain version runs its matvecs and Gram band
on :func:`band_rows` too, and past :data:`COMPACT_ABOVE` on their
:func:`compact_rows`.  A
CUDA call the kernels cannot take raises; there is no fallback.

Layouts are batch-first: the band is ``pd``, ``pe`` of shape (B, T, bb, bb)
with ``pd[:, k]`` the diagonal block M_{k,k}'s P part and ``pe[:, k]`` the
sub-diagonal block P_{k+1,k} (``pe[:, T-1]`` zero).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from sqp_solver_tpu_torch.ops.qp_kernel import (
    AA_SOLVES,
    AdmmOps,
    _aa_args,
    _aa_workspace,
    _admm_core,
    _check_cuda_operands,
    _check_qp_settings,
    _check_shape,
    _cholesky_clamped,
    _library,
    _mtv,
    _mv,
    _ptr,
    _raise_on,
    _schedule,
    _tri_inv,
    qp_result,
)
from sqp_solver_tpu_torch.qp.types import QPResult, QPSettings, QPState, QuadraticProblem

__all__ = [
    "BtdOut",
    "CompactRows",
    "band_rows",
    "compact_nnz",
    "compact_rows",
    "btd_internal_block",
    "extract_band",
    "qp_btd_reference",
    "qp_solve_kernel_btd",
    "btd_step_kernel",
    "wide_layout",
    "wide_route_counts",
]

# The internal blocks the narrow CUDA kernel is built for (a cluster of two
# blocks per problem for 8 and 16 only); the wide kernel takes every other
# multiple of 8 at the shapes its layout places (wide_layout).
KERNEL_BLOCKS = (8, 16, 24, 32)
# Internal blocks past this take the wide kernel's compact route: A's band
# rows held by their nonzeros, the cluster the layout rule's
# (csrc/qp_kernel_btd_wide.cu:kWideCompactAbove)
COMPACT_ABOVE = 128

# Launch counters, one per entry point of each CUDA kernel (narrow, wide):
# each wrapper adds one where it launches a kernel (never on the plain path).
qp_solve_btd_launches = 0
btd_step_launches = 0
qp_solve_btd_wide_launches = 0
btd_step_wide_launches = 0
# The problems each route of the wide kernel took, summed on each device
# by the wrappers with no read back to the host ((2,) int64: band, dense);
# read with wide_route_counts()
_wide_routes: dict = {}


class BtdOut(NamedTuple):
    """Raw result of one structured solve, each field batch-first (the nine
    stats rows of the TPU kernel, in its order, after the iterates)."""

    x: torch.Tensor  # (B, n)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m)
    done: torch.Tensor  # bool (B,) converged, or inactive on entry
    iter: torch.Tensor  # int32 (B,)
    res_prim: torch.Tensor  # (B,)
    res_dual: torch.Tensor  # (B,)
    fail: torch.Tensor  # bool (B,) a block factor hit a clamped pivot
    rho_updates: torch.Tensor  # int32 (B,)
    rho_estimate: torch.Tensor  # (B,)
    infs: torch.Tensor  # int32 (B,) certificate: 0 none, 1 primal, 2 dual
    rho_factor: torch.Tensor  # (B,) rho the final factor was computed under
    # bool (B,): the problem took the wide route's band rows (None: the
    # dense route of the narrow kernel and of the oracle)
    band: Optional[torch.Tensor] = None


def btd_internal_block(b: int) -> int:
    """The block size the band is read at for a declared block size ``b``:
    ``b`` itself when a multiple of 8, else the smallest multiple of 8
    covering the half-bandwidth 2 b - 1 that block-tridiagonal at ``b``
    implies."""
    if b % 8 == 0:
        return b
    return -(-(2 * b - 1) // 8) * 8


def extract_band(P: torch.Tensor, bb: int):
    """(B, n, n) -> ``(pd, pe)``, each (B, T, bb, bb), contiguous:
    ``pd[:, k]`` = P_{k,k}, ``pe[:, k]`` = P_{k+1,k}, ``pe[:, T-1]`` = 0."""
    B, n, _ = P.shape
    T = n // bb
    Pb = P.reshape(B, T, bb, T, bb).permute(0, 1, 3, 2, 4)  # (B, Trow, Tcol, bb, bb)
    pd = torch.diagonal(Pb, 0, 1, 2).permute(0, 3, 1, 2)
    pe = torch.zeros_like(pd)
    if T > 1:
        pe[:, :-1] = torch.diagonal(Pb, -1, 1, 2).permute(0, 3, 1, 2)
    return pd.contiguous(), pe


def _band_pmv(pd, pe, v):
    """P v from the band: (P v)_k = P_{k,k} v_k + P_{k,k-1} v_{k-1} +
    P_{k+1,k}' v_{k+1}."""
    B, T, bb, _ = pd.shape
    vb = v.reshape(B, T, bb)
    out = _mv(pd, vb)
    if T > 1:
        zero = torch.zeros_like(out[:, :1])
        out = out + torch.cat([zero, _mv(pe[:, :-1], vb[:, :-1])], dim=1)
        out = out + torch.cat([_mtv(pe[:, :-1], vb[:, 1:]), zero], dim=1)
    return out.reshape(B, T * bb)


def band_rows(A: torch.Tensor, bb: int):
    """A (B, m, n = T bb) in two-block band rows, the layout of the wide
    kernel: ``(k_r, slabs, fits)`` with ``k_r`` (B, m) int64 the first
    column block of each row's slab (its first nonzero column block, at
    most T - 2; 0 for a zero row), ``slabs`` (B, m, W) its W = min(2, T) bb
    entries from column k_r bb, and ``fits`` (B,) bool: every row of the
    problem lies in its slab (no nonzero, a NaN counting as one, outside
    two consecutive column blocks), so that M = P + sigma I + A' rho A is
    block-tridiagonal at bb and the band products below equal the dense
    ones."""
    B, m, n = A.shape
    T = n // bb
    W = min(2, T) * bb
    nz = A != 0
    col = torch.arange(n, device=A.device)
    first = torch.where(nz, col, n).amin(-1)
    last = torch.where(nz, col, -1).amax(-1)
    kf = torch.where(first == n, 0, first // bb)
    kl = torch.clamp_min(last, 0) // bb
    k_r = torch.clamp(kf, max=max(T - 2, 0))
    fits = (kl <= k_r + 1).all(-1)
    return k_r, torch.gather(A, 2, _band_cols(k_r, bb, W)), fits


def _band_cols(k_r, bb: int, W: int):
    """The columns of each band row's entries, (B, m, W)."""
    return k_r.unsqueeze(-1) * bb + torch.arange(W, device=k_r.device)


def _band_amv(band, v, bb: int):
    """A v from the band rows: each slab against v's two blocks."""
    k_r, slabs, _ = band
    B, m, W = slabs.shape
    seg = torch.gather(v.unsqueeze(1).expand(B, m, v.shape[-1]), 2, _band_cols(k_r, bb, W))
    return (slabs * seg).sum(-1)


def _band_atmv(band, w, bb: int, n: int):
    """A' w from the band rows: each slab scaled by its row's w, added into
    its two column blocks."""
    k_r, slabs, _ = band
    B, m, W = slabs.shape
    out = torch.zeros((B, n), dtype=slabs.dtype, device=slabs.device)
    return out.scatter_add_(1, _band_cols(k_r, bb, W).reshape(B, m * W),
                            (slabs * w.unsqueeze(-1)).reshape(B, m * W))


def _band_gram(band, rv, T: int, bb: int):
    """The Gram band of A' diag(rv) A from the band rows: D_k = sum of
    a_rk' rho_r a_rk over the rows whose slab covers column block k, E_k
    = sum of a_r,k+1' rho_r a_rk over those whose slab starts at k.
    Returns (D, E), each (B, T, bb, bb)."""
    k_r, slabs, _ = band
    B = slabs.shape[0]
    a0 = slabs[..., :bb]
    a1 = slabs[..., bb:]
    D = slabs.new_zeros((B, T, bb, bb))
    E = slabs.new_zeros((B, T, bb, bb))
    for k in range(T):
        at0 = (k_r == k).to(slabs.dtype) * rv
        D[:, k] = torch.einsum("bri,brj->bij", a0, a0 * at0.unsqueeze(-1))
        if k > 0:
            at1 = (k_r + 1 == k).to(slabs.dtype) * rv
            D[:, k] += torch.einsum("bri,brj->bij", a1, a1 * at1.unsqueeze(-1))
        if k + 1 < T:
            E[:, k] = torch.einsum("bri,brj->bij", a1, a0 * at0.unsqueeze(-1))
    return D, E


class CompactRows(NamedTuple):
    """A's band rows held by their nonzeros (the wide route past internal
    block :data:`COMPACT_ABOVE`): each row's slab start ``k_r`` (B, m) as
    :func:`band_rows`', its nonzero entries (a NaN counting as one) in
    column order, ``vals`` (B, m, K), with their columns inside the slab,
    ``cols`` (B, m, K), K the most any row has, ``valid`` (B, m, K) marking
    the entries a row has, and ``fits`` as :func:`band_rows`'."""

    k_r: torch.Tensor
    vals: torch.Tensor
    cols: torch.Tensor
    valid: torch.Tensor
    fits: torch.Tensor


def compact_rows(band) -> CompactRows:
    """:func:`band_rows`' ``(k_r, slabs, fits)`` held by their nonzeros."""
    k_r, slabs, fits = band
    nz = slabs != 0
    cnt = nz.sum(-1)
    K = int(cnt.max()) if cnt.numel() else 0
    # the nonzero columns first, each in column order (a stable sort)
    cols = torch.sort((~nz).to(torch.int8), dim=-1, stable=True).indices[..., :K]
    valid = torch.arange(K, device=slabs.device) < cnt.unsqueeze(-1)
    vals = torch.where(valid, torch.gather(slabs, -1, cols), 0.0)
    return CompactRows(k_r, vals, torch.where(valid, cols, 0), valid, fits)


def _compact_amv(rows: CompactRows, v, bb: int):
    """A v over each row's nonzero entries."""
    B, m, K = rows.vals.shape
    at = rows.k_r.unsqueeze(-1) * bb + rows.cols
    seg = torch.gather(v.unsqueeze(1).expand(B, m, v.shape[-1]), 2, at)
    return torch.where(rows.valid, rows.vals * seg, 0.0).sum(-1)


def _compact_atmv(rows: CompactRows, w, bb: int, n: int):
    """A' w: each row's nonzero entries scaled by its w, added into their
    columns."""
    B, m, K = rows.vals.shape
    out = torch.zeros((B, n), dtype=rows.vals.dtype, device=rows.vals.device)
    at = (rows.k_r.unsqueeze(-1) * bb + rows.cols).reshape(B, m * K)
    add = torch.where(rows.valid, rows.vals * w.unsqueeze(-1), 0.0).reshape(B, m * K)
    return out.scatter_add_(1, at, add)


def _compact_gram(rows: CompactRows, rv, T: int, bb: int):
    """The Gram band of A' diag(rv) A from the compact rows, (D, E) as
    :func:`_band_gram`'s: each row's entries put back into its slab."""
    B, m, K = rows.vals.shape
    W = min(2, T) * bb
    slabs = rows.vals.new_zeros((B, m, W)).scatter_add_(2, rows.cols, rows.vals)
    return _band_gram((rows.k_r, slabs, rows.fits), rv, T, bb)


def _dense_gram(A, rv, T: int, bb: int):
    """The Gram band of A' diag(rv) A from A itself, (D, E) as
    :func:`_band_gram`'s."""
    B, m, _ = A.shape
    Ab = A.reshape(B, m, T, bb)
    Aw = Ab * rv[:, :, None, None]
    D = torch.einsum("brki,brkj->bkij", Ab, Aw)
    E = torch.zeros_like(D)
    if T > 1:
        E[:, :-1] = torch.einsum("brki,brkj->bkij", Ab[:, :, 1:], Aw[:, :, :-1])
    return D, E


def _btd_factor(pd, pe, A, rv, sigma, band=None):
    """Gram band and block-Thomas Cholesky of M = P + sigma I + A' diag(rv) A
    restricted to the band (the Gram from the band rows ``band`` of
    :func:`band_rows`, or from their :class:`CompactRows`, where its
    problem fits, else from A).  Returns
    ``((Li, G, H), fail)``: Li[:, k] = L_k^-1, and the sweeps' couplings
    G[:, k] = L_k^-1 F_{k-1} (G[:, 0] = 0) and H[:, k] = L_k^-T F_k'
    (H[:, T-1] = 0) of F_k = E_k L_k^-T; fail if any block's pivot was
    clamped."""
    B, T, bb, _ = pd.shape
    if band is None:
        DA, EA = _dense_gram(A, rv, T, bb)
    else:
        if isinstance(band, CompactRows):
            DA, EA = _compact_gram(band, rv, T, bb)
            fits = band.fits
        else:
            DA, EA = _band_gram(band, rv, T, bb)
            fits = band[2]
        if not bool(fits.all()):
            DD, ED = _dense_gram(A, rv, T, bb)
            sel = fits[:, None, None, None]
            DA, EA = torch.where(sel, DA, DD), torch.where(sel, EA, ED)
    eye = torch.eye(bb, dtype=pd.dtype, device=pd.device)
    D = pd + sigma * eye + DA
    E = pe + EA
    Li, G, H = torch.empty_like(pd), torch.zeros_like(pd), torch.zeros_like(pd)
    fail = torch.zeros(B, dtype=torch.bool, device=pd.device)
    Fp = torch.zeros_like(pd[:, 0])
    for k in range(T):
        L, f = _cholesky_clamped(D[:, k] - torch.matmul(Fp, Fp.mT))
        Lik = _tri_inv(L)
        Fk = torch.matmul(E[:, k], Lik.mT)
        Li[:, k] = Lik
        if k > 0:
            G[:, k] = torch.matmul(Lik, Fp)
        if k + 1 < T:
            H[:, k] = torch.matmul(Lik.mT, Fk.mT)
        Fp = Fk
        fail = fail | f
    return (Li, G, H), fail


def _btd_apply(factor, b):
    """M^-1 b in four phases: c_k = L_k^-1 b_k for all k; the forward chain
    w_k = c_k - G_k w_{k-1}; d_k = L_k^-T w_k for all k; the backward chain
    x_k = d_k - H_k x_{k+1}."""
    Li, G, H = factor
    B, T, bb, _ = Li.shape
    c = _mv(Li, b.reshape(B, T, bb))
    w = [c[:, 0]]
    for k in range(1, T):
        w.append(c[:, k] - _mv(G[:, k], w[-1]))
    d = _mtv(Li, torch.stack(w, dim=1))
    x = [d[:, T - 1]]
    for k in reversed(range(T - 1)):
        x.append(d[:, k] - _mv(H[:, k], x[-1]))
    return torch.stack(x[::-1], dim=1).reshape(B, T * bb)


def qp_btd_reference(pd, pe, A, q, l, u, x, z, y, settings: QPSettings,
                     active: Optional[torch.Tensor] = None,
                     rho_in: Optional[torch.Tensor] = None,
                     check_infeas: bool = False, band: bool = False) -> BtdOut:
    """Plain version of the structured kernel: the ADMM solve entered with
    a pending rho (the first epoch adopts it and factors the band), rho
    epochs, chunks with per-problem early exit, adaptive rho and, with
    ``check_infeas``, the infeasibility certificates.  ``active`` (bool
    (B,), default all) freezes the other problems on entry; ``rho_in``
    (B,) > 0 replaces rho0 for a problem (an SOC re-solve carries the rho
    of the first solve's final factor).  With ``band`` (the wide route),
    A v, A' w and the Gram band run on :func:`band_rows` for the problems
    that fit (past internal block :data:`COMPACT_ABOVE` on their
    :func:`compact_rows`) and densely for the others, and ``BtdOut.band``
    says which; without it A is dense throughout (the oracle)."""
    batch = q.shape[0]
    dev = q.device
    seg, cpe, n_epochs = _schedule(settings)
    sigma = float(settings.sigma)
    # rho from q as the kernels do: a NaN in q's first entry poisons rho
    rho = float(settings.rho) + 0.0 * q[:, 0]
    if rho_in is not None:
        # the TPU kernel's arithmetic select, reproduced to the rounding
        rho = rho + (rho_in > 0).to(q.dtype) * (rho_in - rho)
    if active is None:
        active = torch.ones(batch, dtype=torch.bool, device=dev)
    bb = pd.shape[-1]
    n = q.shape[-1]
    rows = band_rows(A, bb) if band else None
    amv, atmv = (lambda v: _mv(A, v)), (lambda w: _mtv(A, w))
    if rows is not None:
        fits = rows[2]
        sel = fits.unsqueeze(-1)
        if bb > COMPACT_ABOVE:
            rows = compact_rows(rows)
            bamv = lambda v: _compact_amv(rows, v, bb)  # noqa: E731
            batmv = lambda w: _compact_atmv(rows, w, bb, n)  # noqa: E731
        else:
            bamv = lambda v: _band_amv(rows, v, bb)  # noqa: E731
            batmv = lambda w: _band_atmv(rows, w, bb, n)  # noqa: E731
        if bool(fits.all()):
            amv, atmv = bamv, batmv
        else:
            amv = lambda v: torch.where(sel, bamv(v), _mv(A, v))  # noqa: E731
            atmv = lambda w: torch.where(sel, batmv(w), _mtv(A, w))  # noqa: E731
    ops = AdmmOps(pmv=lambda v: _band_pmv(pd, pe, v), apply_minv=_btd_apply, amv=amv,
                  atmv=atmv)
    false = torch.zeros(batch, dtype=torch.bool, device=dev)
    out = _admm_core(
        ops, q, l, u, x, z, y, ~active, false, rho,
        tuple(torch.zeros_like(pd) for _ in range(3)),
        lambda rv: _btd_factor(pd, pe, A, rv, sigma, rows),
        sigma=sigma, alpha=float(settings.alpha),
        eps_abs=float(settings.eps_abs), eps_rel=float(settings.eps_rel),
        n_epochs=n_epochs, chunks_per_epoch=cpe, seg=seg,
        adaptive_rho=bool(settings.adaptive_rho),
        adaptive_rho_tolerance=float(settings.adaptive_rho_tolerance),
        pending=active, check_infeas=check_infeas,
        eps_pinf=float(settings.eps_pinf), eps_dinf=float(settings.eps_dinf),
        **_aa_args(settings),
    )
    return BtdOut(
        x=out["x"], z=out["z"], y=out["y"], done=out["done"], iter=out["iter"],
        res_prim=out["res_prim"], res_dual=out["res_dual"], fail=out["fail"],
        rho_updates=out["rho_updates"], rho_estimate=out["rho_estimate"],
        infs=out["infs"], rho_factor=out["rho"], band=None if rows is None else fits,
    )


def _wide_route(bb: int) -> bool:
    """Whether the internal block ``bb`` takes the wide route (band rows)
    rather than the narrow kernel's dense one; on the CPU any block past
    those of the narrow kernel does."""
    return bb not in KERNEL_BLOCKS


def is_wide(bb: int, name: str = "qp_kernel_btd") -> bool:
    """Whether the wide CUDA kernel (rather than the narrow one) takes the
    internal block ``bb``: every multiple of 8 but those of the narrow one;
    raises ``ValueError`` where neither does (the wide kernel may still
    refuse a shape, where :func:`wide_layout` returns None)."""
    if bb in KERNEL_BLOCKS:
        return False
    if bb % 8 == 0 and bb > 0:
        return True
    raise ValueError(f"{name}: the CUDA kernels take internal blocks that are multiples of 8, "
                     f"not {bb}")


def _qp_btd_launch(pd, pe, A, q, l, u, x, z, y, settings: QPSettings,
                   active, rho_in, check_infeas: bool, name: str,
                   cluster: Optional[int] = None, lib=None,
                   nnz: Optional[tuple] = None) -> BtdOut:
    """One launch of a structured CUDA kernel on float32 CUDA operands, with
    the blocks per problem of its rule (:func:`cluster_size`) or, for the
    tests and the measurements, ``cluster``: the narrow one (1 or 2); the
    wide kernel takes its layout's only (``BtdOut.band`` its route per
    problem; past internal block :data:`COMPACT_ABOVE` the layout is the
    rule's for ``nnz``, the nonzeros a block holds, or, where None,
    :func:`compact_nnz` of ``A``, one read back to the host); from the
    package's library or from ``lib`` (another build, as
    ``tools/kernel_ab.py`` passes)."""
    batch, n = q.shape
    m = l.shape[-1]
    bb = pd.shape[-1]
    wide = is_wide(bb, name)
    operands = dict(pd=pd, pe=pe, A=A, q=q, l=l, u=u, x=x, z=z, y=y, active=active,
                    rho_in=rho_in)
    dev = _check_cuda_operands(name, operands, dict(active=torch.bool))
    lib = lib or _library()
    f32 = dict(dtype=torch.float32, device=dev)
    x_out = torch.empty((batch, n), **f32)
    z_out = torch.empty((batch, m), **f32)
    y_out = torch.empty((batch, m), **f32)
    stats = torch.empty((9, batch), **f32)  # one contiguous row per field
    seg, cpe, n_epochs = _schedule(settings)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        _ptr(pd), _ptr(pe), _ptr(A), _ptr(q), _ptr(l), _ptr(u), _ptr(active),
        _ptr(rho_in), _ptr(x), _ptr(z), _ptr(y),
        _ptr(x_out), _ptr(z_out), _ptr(y_out), _ptr(stats),
        batch, n, m, bb,
        float(settings.sigma), float(settings.alpha), float(settings.rho),
        float(settings.eps_abs), float(settings.eps_rel),
        n_epochs, cpe, seg, int(bool(settings.adaptive_rho)),
        float(settings.adaptive_rho_tolerance), int(bool(check_infeas)),
        float(settings.eps_pinf), float(settings.eps_dinf),
        dev.index, ctypes.c_void_p(stream),
    )
    route = None
    if wide:
        # a library built before the compact route has entries of its own
        # and takes no nonzero counts
        current = hasattr(lib, "qp_btd_wide_launch_nnz")
        if current and bb > COMPACT_ABOVE and nnz is None:
            nnz = compact_nnz(A, bb)
        aa_k = int(settings.anderson_memory) if settings.acceleration == "anderson" else 0
        lay = wide_layout(n, m, bb, nnz=nnz, anderson=max(aa_k, 0), lib=lib)
        if lay is None:
            raise ValueError(f"{name}: the vectors of n={n}, m={m} do not fit in the shared "
                             "memory of a cluster's block")
        cs, ws_floats = lay["cluster"], lay["workspace_floats"]
        if cluster not in (None, cs):
            raise ValueError(f"{name}: the wide kernel (internal block {bb}) runs a cluster of "
                             f"{cs} blocks per problem at this shape, not {cluster}")
        # one slice of the Anderson state a block: a cluster's block holds
        # all of x and ceil(m / cs) rows
        aa_mem, aa_ws = _aa_workspace(lib, settings, batch * cs, n, -(-m // cs), dev)
        ws = torch.empty((batch * cs * ws_floats,), **f32) if ws_floats else None
        route = torch.empty((batch,), dtype=torch.bool, device=dev)
        wargs = (*args, _ptr(ws), _ptr(route))
        if current:
            nz = _nnz_args(nnz)
            rc = (lib.qp_btd_wide_launch_aa_nnz(*wargs, aa_mem, _ptr(aa_ws), nz) if aa_mem
                  else lib.qp_btd_wide_launch_nnz(*wargs, nz))
        else:
            rc = (lib.qp_btd_wide_launch_aa(*wargs, aa_mem, _ptr(aa_ws)) if aa_mem
                  else lib.qp_btd_wide_launch(*wargs))
    elif settings.acceleration == "anderson":
        # one slice of the Anderson state a block: a cluster's block holds
        # all of x and ceil(m / cs) rows
        cs = cluster or int(lib.qp_btd_cluster_size(n, m, bb, batch))
        aa_mem, aa_ws = _aa_workspace(lib, settings, batch * cs, n, -(-m // cs), dev)
        rc = lib.qp_btd_launch_aa(cs, *args, aa_mem, _ptr(aa_ws))
    elif cluster is None:
        # without Anderson the launch keeps the interface of the kernels
        # before it (tools/kernel_ab.py calls another tree's library)
        rc = lib.qp_btd_launch(*args)
    else:
        rc = lib.qp_btd_launch_as(cluster, *args)
    _raise_on(lib, rc, name)
    if route is not None:
        _count_routes(route)
    i32 = torch.int32
    return BtdOut(
        x=x_out, z=z_out, y=y_out, done=stats[0] > 0.5, iter=stats[1].to(i32),
        res_prim=stats[2], res_dual=stats[3], fail=stats[4] > 0.5,
        rho_updates=stats[5].to(i32), rho_estimate=stats[6], infs=stats[7].to(i32),
        rho_factor=stats[8], band=route,
    )


def _count_routes(route: torch.Tensor) -> None:
    """Adds a wide launch's routes to its device's tally, on the device
    with no read back to the host (``torch.bincount`` would read its
    input's range back, stalling the host at every launch)."""
    tally = _wide_routes.get(route.device)
    if tally is None:
        tally = _wide_routes[route.device] = torch.zeros(2, dtype=torch.int64,
                                                         device=route.device)
    band = route.sum()
    tally += torch.stack([band, route.numel() - band])


def wide_route_counts() -> dict:
    """The problems the wide kernel's launches have taken through each
    route since the last :func:`reset_wide_route_counts`: ``{"band": ...,
    "dense": ...}`` (a host sync)."""
    out = dict(band=0, dense=0)
    for tally in _wide_routes.values():
        band, dense = (int(v) for v in tally.tolist())
        out["band"] += band
        out["dense"] += dense
    return out


def reset_wide_route_counts() -> None:
    _wide_routes.clear()


def cluster_size(n: int, m: int, bb: int, batch: int, lib=None,
                 nnz: Optional[tuple] = None) -> int:
    """Thread blocks per problem the CUDA kernel takes at these sizes on
    the current card.  Narrow kernel: 2 (a cluster) where one block cannot
    hold all of A in shared memory and two hold more of it, or where one
    block per problem would leave half of the SMs idle (2 B <= SMs) and
    two hold all of A; else 1 (internal blocks 8 and 16 only).  Wide
    kernel: its layout's (2 up to internal block :data:`COMPACT_ABOVE`,
    past it the rule's for ``nnz``, :func:`wide_layout`'s; 0 where the
    layout refuses the shape).  Needs the built library (or ``lib``)."""
    lib = lib or _library()
    if is_wide(bb):
        lay = wide_layout(n, m, bb, nnz=nnz, lib=lib)
        return 0 if lay is None else lay["cluster"]
    return int(lib.qp_btd_cluster_size(n, m, bb, batch))


def smem_rows(n: int, m: int, bb: int, batch: int, nnz: Optional[tuple] = None) -> int:
    """Rows of A the CUDA kernel keeps in shared memory at these sizes, over
    the blocks of one problem (the rest it reads from device memory; the
    wide kernel all of its band rows or none, past internal block
    :data:`COMPACT_ABOVE` for ``nnz``); needs the built library."""
    lib = _library()
    if is_wide(bb):
        lay = wide_layout(n, m, bb, nnz=nnz, lib=lib)
        return m if lay is not None and "A" in lay["shared"] else 0
    return int(lib.qp_btd_smem_rows(n, m, bb, batch))


WIDE_ARRAYS = ("Li", "GH", "A", "S", "F_prev", "F", "pd", "pe")
# the compact route's scratch arrays (XScratch), after A in its mask: the
# runner's F_{k-1}, the Gram's D and E partials
COMPACT_SCRATCH = ("F_prev", "D_part", "E_part")
# the clusters the compact route's rule weighs, in its order
COMPACT_CLUSTERS = (2, 4, 8)


def compact_nnz(A: torch.Tensor, bb: int) -> tuple:
    """The most nonzeros (a NaN counting as one) that a block of any
    problem's cluster holds on the compact route, at each cluster of
    :data:`COMPACT_CLUSTERS` (block r holds the rows r, r + cs, ...): the
    ``nnz`` of :func:`wide_layout`.  One read back to the host."""
    B, m, _ = A.shape
    per_row = (A != 0).sum(-1)
    out = []
    for cs in COMPACT_CLUSTERS:
        m0 = -(-m // cs)
        pad = torch.nn.functional.pad(per_row, (0, m0 * cs - m))
        out.append(pad.reshape(B, m0, cs).sum(1).amax() if B else per_row.new_zeros(()))
    return tuple(int(v) for v in torch.stack(out).tolist())


def _matrix_names(T: int) -> list:
    """The compact route's matrices of the sweeps in their numbering (xj_g,
    xj_h, xj_l): G_1 .. G_{T-1}, H_0 .. H_{T-2}, L_0 .. L_{T-1}."""
    return ([f"G{k}" for k in range(1, T)] + [f"H{k}" for k in range(T - 1)]
            + [f"L{k}" for k in range(T)])


def _layout_dict(v: list, anderson: int) -> dict:
    """A layout report (qp_btd_wide_layout_nnz's 18 values) as a dict."""
    out = dict(cluster=v[0], smem_bytes=v[1], workspace_floats=v[2], iter_bytes=v[4], T=v[5],
               rows_per_member=v[7], band_width=v[8], fixed_floats=v[10])
    if anderson:
        out["gram_shared"] = bool(v[11])
        out["solve"], out["solve_floats"] = AA_SOLVES[v[16]], v[17]
    mask = v[3]
    if v[12] == 0:
        names = [(a, bool(mask >> i & 1)) for i, a in enumerate(WIDE_ARRAYS)]
        out.update(route="band", blocks_per_member=v[6], band_stride=v[9])
    else:
        T, cs, slots_sm = v[5], v[0], v[13]
        names = [("A", bool(mask & 1))]
        names += [(a, j // cs < slots_sm) for j, a in enumerate(_matrix_names(T))]
        names += [(a, bool(mask >> (i + 1) & 1)) for i, a in enumerate(COMPACT_SCRATCH)]
        out.update(route="compact", matrix_slots=v[6], nnz=v[9], slots_shared=slots_sm,
                   a_first=bool(v[14]))
    out["shared"] = [a for a, on in names if on]
    out["device"] = [a for a, on in names if not on]
    return out


def _nnz_args(nnz):
    """The C entries' nnz values (xwide_rule's kXNnzArgs: the counts at each
    cluster of :data:`COMPACT_CLUSTERS`), or None."""
    return None if nnz is None else (ctypes.c_longlong * len(COMPACT_CLUSTERS))(*nnz)


def wide_layout(n: int, m: int, bb: int, nnz: Optional[tuple] = None, anderson: int = 0,
                lib=None, reserve: int = 0):
    """The wide kernel's layout of a launch at this shape, as
    ``csrc/qp_kernel_btd_wide.cu`` computes it (``qp_btd_wide_layout_nnz``),
    with Anderson of memory ``anderson`` (0: none) and, past internal block
    :data:`COMPACT_ABOVE`, for the nonzeros a block holds (``nnz``,
    :func:`compact_nnz`'s; None: the band rows' full count).  ``cluster``
    (blocks a problem), ``smem_bytes`` (a block's), ``workspace_floats`` (of
    one block), ``shared`` and ``device`` (which arrays each block keeps
    where), ``iter_bytes`` (the bytes an ADMM iteration reads from device
    memory, a problem), ``T``, ``rows_per_member``, ``band_width``,
    ``fixed_floats``, ``route`` and with Anderson ``gram_shared`` (its Gram
    area in shared memory), ``solve`` (where the chunk's system goes, one of
    ``qp_kernel.AA_SOLVES``) and ``solve_floats`` (its solve area's in
    shared memory).  With ``reserve`` (and no Anderson) the layout with that
    many floats reserved where an Anderson launch reserves its areas (the
    layouts its placement rule compares).  Up to 128 (``route`` "band": a cluster of two,
    A in two-block band rows; pd and pe that shared memory cannot hold are
    read where they are given) the arrays are L^-1, the sweeps' couplings
    G, H, A's band rows, the Thomas scratch S, F_{k-1}, F_k, pd and pe, and
    ``blocks_per_member`` (column blocks a block holds, at most) and
    ``band_stride`` complete it; past it (``route`` "compact": the smallest
    cluster of :data:`COMPACT_CLUSTERS` at which an iteration reads nothing
    from device memory, else the one, and the order, that reads the fewest
    bytes) the arrays are A (its nonzeros), each matrix of the sweeps (G1
    .., H0 .., L0 ..: a slot of one block each) and the factor's scratch
    F_prev, D_part, E_part, and ``matrix_slots`` (a block's),
    ``slots_shared`` (those in shared memory), ``nnz`` (the entries a block
    has room for) and ``a_first`` complete it.  None where the shape is
    refused.  Needs the built library (or ``lib``); a library built before
    the compact route reports its own."""
    lib = lib or _library()
    if reserve:
        out = (ctypes.c_longlong * 18)()
        if int(lib.qp_btd_wide_layout_reserve(n, m, bb, reserve, _nnz_args(nnz), out)) != 0:
            return None
        return _layout_dict(list(out), 0)
    if hasattr(lib, "qp_btd_wide_layout_nnz"):
        # 18 values; a library built before the Anderson step's solve areas
        # writes the first 16 (its system always in the Gram area)
        out = (ctypes.c_longlong * 18)()
        if int(lib.qp_btd_wide_layout_nnz(n, m, bb, anderson, _nnz_args(nnz), out)) != 0:
            return None
        return _layout_dict(list(out), anderson)
    out = (ctypes.c_longlong * 12)()
    aa = anderson and hasattr(lib, "qp_btd_wide_layout_aa")
    rc = lib.qp_btd_wide_layout_aa(n, m, bb, anderson, out) if aa else lib.qp_btd_wide_layout(
        n, m, bb, out)
    if int(rc) != 0:
        return None
    return _layout_dict(list(out) + [0] * 6, anderson if aa else 0)


def qp_solve_kernel_btd(qp: QuadraticProblem, settings: QPSettings = QPSettings(),
                        state: Optional[QPState] = None) -> QPResult:
    """Solve a batch of QPs whose Schur matrix is block-tridiagonal at the
    declared ``settings.block_size`` with the structured whole-solve
    kernel, one CUDA thread block or cluster per problem (replaces the TPU's
    ``ops/qp_kernel_btd.py:qp_solve_kernel_btd``).

    Same semantics as ``qp_solve_kernel``: entries of M outside the band
    are ignored.  n is padded to a multiple of the internal block with
    decoupled identity rows (zero q and A columns, unit P diagonal), which
    stay at 0.  CPU tensors run :func:`qp_btd_reference`; CUDA tensors
    must be float32 and contiguous and run the kernel."""
    global qp_solve_btd_launches, qp_solve_btd_wide_launches
    _check_qp_settings(settings)
    name = "qp_solve_kernel_btd"
    P, q, A, l, u = qp.P, qp.q, qp.A, qp.l, qp.u
    batch, n0 = q.shape
    m = A.shape[-2]
    if state is None:
        state = QPState.zeros(batch, n0, m, dtype=q.dtype, device=q.device)
    x0, z0, y0 = state.x, state.z, state.y
    for key, t, shape in (
        ("P", P, (batch, n0, n0)), ("A", A, (batch, m, n0)), ("l", l, (batch, m)),
        ("u", u, (batch, m)), ("x", x0, (batch, n0)), ("z", z0, (batch, m)),
        ("y", y0, (batch, m)),
    ):
        _check_shape(name, key, t, shape)
    bb = btd_internal_block(int(settings.block_size))
    n = -(-n0 // bb) * bb
    if n != n0:
        pad = n - n0
        P = torch.nn.functional.pad(P, (0, pad, 0, pad))
        idx = torch.arange(n0, n, device=P.device)
        P[:, idx, idx] = 1.0
        q = torch.nn.functional.pad(q, (0, pad))
        A = torch.nn.functional.pad(A, (0, pad))
        x0 = torch.nn.functional.pad(x0, (0, pad))
    pd, pe = extract_band(P, bb)
    if q.is_cuda:
        out = _qp_btd_launch(pd, pe, A, q, l, u, x0, z0, y0, settings, None, None,
                             bool(settings.check_infeasibility), name)
        if is_wide(bb):
            qp_solve_btd_wide_launches += 1
        else:
            qp_solve_btd_launches += 1
    else:
        out = qp_btd_reference(pd, pe, A, q, l, u, x0, z0, y0, settings,
                               check_infeas=bool(settings.check_infeasibility),
                               band=_wide_route(bb))
    return qp_result(qp, out, settings)


def btd_step_kernel(pd, pe, J, g, l, u, active, x, z, y, settings: QPSettings,
                    rho_in: Optional[torch.Tensor] = None,
                    nnz: Optional[tuple] = None) -> BtdOut:
    """The warm-started structured QP of one SQP outer iteration,

        min 0.5 p'Bp + g'p   s.t.   l <= J p <= u,

    with B given by its band ``pd``, ``pe`` (B, T, bb, bb), one CUDA thread
    block or cluster per problem (replaces the TPU's ``ops/qp_kernel_btd.py:
    btd_step_kernel``).  ``active`` (bool (B,)) freezes the other problems
    at their warm start; ``rho_in`` (B,), where > 0, replaces rho0 (0 means
    none).  No infeasibility certificates (the SQP tiers run without).
    ``BtdOut.rho_factor`` is the rho of the final factor, which an SOC
    re-solve feeds back as ``rho_in``; past internal block
    :data:`COMPACT_ABOVE` it may pass the first solve's ``nnz``
    (:func:`compact_nnz` of ``J``), which the launch otherwise reads back.
    n must be a multiple of the internal block.  CPU tensors run
    :func:`qp_btd_reference`; CUDA tensors must be float32 and contiguous
    and run the kernel."""
    global btd_step_launches, btd_step_wide_launches
    name = "btd_step_kernel"
    batch, n = g.shape
    m = l.shape[-1]
    bb = btd_internal_block(int(settings.block_size))
    if n % bb:
        raise ValueError(
            f"{name}: n={n} is not a multiple of the internal block {bb} "
            f"(declared block_size={settings.block_size})"
        )
    T = n // bb
    for key, t, shape in (
        ("pd", pd, (batch, T, bb, bb)), ("pe", pe, (batch, T, bb, bb)),
        ("J", J, (batch, m, n)), ("u", u, (batch, m)), ("active", active, (batch,)),
        ("x", x, (batch, n)), ("z", z, (batch, m)), ("y", y, (batch, m)),
        ("rho_in", rho_in, (batch,)),
    ):
        _check_shape(name, key, t, shape)
    if not g.is_cuda:
        return qp_btd_reference(pd, pe, J, g, l, u, x, z, y, settings, active=active,
                                rho_in=rho_in, band=_wide_route(bb))
    out = _qp_btd_launch(pd, pe, J, g, l, u, x, z, y, settings, active, rho_in, False, name,
                         nnz=nnz)
    if is_wide(bb):
        btd_step_wide_launches += 1
    else:
        btd_step_launches += 1
    return out
