"""The fused tier's ADMM chunk kernel K5 (twin of ``sqp_solver_tpu/ops/admm_kernel.py``).

The hot loop of the fused QP solver is ``seg`` iterations of

    rhs  = [sigma x - q ; rho .* z - y]
    xz   = W @ rhs                      # W = fused iteration operator
    pre  = alpha xz + (1 - alpha) [x; z]
    s'   = clip(pre + [0; y / rho], [-inf; l], [+inf; u])
    y'   = y + rho .* (pre - s')[n:]

on padded D = n + m vectors (state s = [x; z], dual yp = [0; y], bounds
[-inf; l] and [+inf; u], rhop = [0; rho], rhoip = [0; 1/rho], scale1 =
[sigma; rho]), so that the x-update and the box projection are one clip,
followed by the chunk-end residual stats (B, 4): res_prim, res_dual,
max(|Ax|, |z|) and max(|Px|, |A'y|, |q|).

Three parts:

* :func:`admm_chunk_reference`, the plain PyTorch version (twin of
  ``admm_chunk_xla``): the CPU path and the card's oracle;
* the CUDA kernel in ``csrc/admm_kernel.cu``, one thread block per
  problem with W on chip for the whole chunk (shared memory, and
  registers for the rows that do not fit there) up to D = 1024, and past
  that (up to 2048) a variant with two rows a thread that reads W from
  device memory every iteration;
* :func:`admm_chunk_kernel`, the wrapper that launches it on float32 CUDA
  operands and raises on anything else, and :func:`admm_chunk`, which
  sends CPU tensors to the plain version and CUDA tensors to the kernel.

Everything is batch-first.  Unlike the TPU kernel there is no ``A'``
operand (that was a Mosaic workaround) and no batch padding to a tile.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["admm_chunk", "admm_chunk_kernel", "admm_chunk_layout", "admm_chunk_reference",
           "admm_chunk_smem_rows"]

# Launch counter: the wrapper adds one where it launches the CUDA kernel.
admm_chunk_launches = 0

_MAX_D = 2048  # one thread per row of W, two past a block's 1024 threads


def chunk_stats(P, A, q, x, z, y):
    """(B, 4): [res_prim, res_dual, max_Ax_z, max_Px_ATy_q]."""
    from sqp_solver_tpu_torch.ops.qp_kernel import _admm_stats, dense_ops

    return torch.stack(_admm_stats(dense_ops(P, A), q, x, z, y), dim=-1)


def admm_chunk_reference(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, *, alpha, seg):
    """Plain version of K5: ``seg`` padded ADMM iterations, then the stats.
    Returns ``(s, yp, stats)``."""
    n = P.shape[-1]
    ysel = rhoip * rhop  # [0_n; 1_m]
    for _ in range(seg):
        rhs = scale1 * s - qv - ysel * yp
        pre = alpha * torch.matmul(W, rhs.unsqueeze(-1)).squeeze(-1) + (1.0 - alpha) * s
        s_new = torch.clamp(pre + rhoip * yp, min=lp, max=up)
        yp = yp + rhop * (pre - s_new)
        s = s_new
    return s, yp, chunk_stats(P, A, qv[:, :n], s[:, :n], s[:, n:], yp[:, n:])


def _check(name, W, P, A, vecs):
    B, D = vecs["s"].shape
    n = P.shape[-1]
    m = A.shape[-2]
    if n + m != D:
        raise ValueError(f"{name}: D = {D} is not n + m = {n} + {m}")
    for key, t, shape in (("W", W, (B, D, D)), ("P", P, (B, n, n)), ("A", A, (B, m, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")
    for key, t in vecs.items():
        if tuple(t.shape) != (B, D):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {(B, D)}")
    return B, n, m


def admm_chunk_kernel(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, *, alpha, seg):
    """Launch K5 (replaces the TPU's ``ops/admm_kernel.py:admm_chunk_pallas``):
    one CUDA thread block per problem.  Every operand must be a float32,
    contiguous CUDA tensor: W (B, D, D), P (B, n, n), A (B, m, n) and the
    eight (B, D) vectors, D = n + m <= 2048.  Returns ``(s, yp, stats)``."""
    return _admm_chunk_launch(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, alpha=alpha,
                              seg=seg)


def _admm_chunk_launch(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, *, alpha, seg,
                       lib=None):
    """One launch of K5 (``lib``: a kernel library other than the package's,
    as ``tools/kernel_ab.py`` passes)."""
    global admm_chunk_launches
    from sqp_solver_tpu_torch.ops.qp_kernel import _check_cuda_operands, _ptr, _raise_on

    name = "admm_chunk_kernel"
    vecs = dict(qv=qv, scale1=scale1, rhoip=rhoip, rhop=rhop, lp=lp, up=up, s=s, yp=yp)
    batch, n, m = _check(name, W, P, A, vecs)
    dev = _check_cuda_operands(name, dict(W=W, P=P, A=A, **vecs), {})
    if n + m > _MAX_D:
        raise ValueError(f"{name}: D = n + m = {n + m} exceeds {_MAX_D}")
    if lib is None:
        from sqp_solver_tpu_torch.ops import _build

        lib = _build.load()
    s_out = torch.empty_like(s)
    yp_out = torch.empty_like(yp)
    stats = torch.empty((batch, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.admm_chunk_launch(
        _ptr(W), _ptr(P), _ptr(A), _ptr(qv), _ptr(scale1), _ptr(rhoip), _ptr(rhop),
        _ptr(lp), _ptr(up), _ptr(s), _ptr(yp), _ptr(s_out), _ptr(yp_out), _ptr(stats),
        batch, n, m, float(alpha), float(1.0 - alpha), int(seg), dev.index,
        ctypes.c_void_p(stream),
    )
    _raise_on(lib, rc, name)
    admm_chunk_launches += 1
    return s_out, yp_out, stats


def admm_chunk(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, *, alpha, seg):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    args = (W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp)
    if s.is_cuda:
        return admm_chunk_kernel(*args, alpha=alpha, seg=seg)
    _check("admm_chunk", W, P, A, dict(qv=qv, scale1=scale1, rhoip=rhoip, rhop=rhop,
                                        lp=lp, up=up, s=s, yp=yp))
    return admm_chunk_reference(*args, alpha=alpha, seg=seg)


def admm_chunk_smem_rows(n: int, m: int) -> int:
    """Rows of W that K5 holds in shared memory at this shape (all D
    rows while they fit)."""
    return admm_chunk_layout(n, m)["smem_rows"]


def admm_chunk_layout(n: int, m: int) -> dict:
    """Where K5 keeps the D = n + m rows of W at this shape: in shared
    memory, in registers (split over the block's lanes, where shared
    memory cannot hold them all and D <= 288), and read from device memory
    each iteration (the rest: all of them past D = 1024)."""
    from sqp_solver_tpu_torch.ops import _build

    lib = _build.load()
    smem, reg = int(lib.admm_chunk_smem_rows(n, m)), int(lib.admm_chunk_reg_rows(n, m))
    return dict(smem_rows=smem, register_rows=reg, device_rows=n + m - smem - reg)
