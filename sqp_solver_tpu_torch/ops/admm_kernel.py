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
* the CUDA kernel in ``csrc/admm_kernel.cu``, which takes one of three
  routes by one layout rule there (:func:`admm_chunk_layout` reports it):
  up to D = 288 one thread block a problem with W on chip (shared memory,
  and registers for the rows that do not fit there); from 289 to 1024,
  where a cluster's shared memory holds W, a cluster of blocks a problem
  with W on chip for the whole chunk; past that (up to 2,125, the JAX
  kernel's limit) a variant that streams W from device memory every
  iteration through a ring of bulk copies, a cluster of blocks a problem;
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
           "admm_chunk_smem_rows", "admm_chunk_wide_layout", "route_counts", "reset_route_counts",
           "ROUTES"]

# Launch counter: the wrapper adds one where it launches the CUDA kernel,
# and one to the route the launch took (route_counts)
admm_chunk_launches = 0
_route_launches = {}

# the JAX kernel's limit: its smallest tile's VMEM footprint reaches its
# 100 MiB limit past D = 2,125 (sqp_solver_tpu/ops/admm_kernel.py:pick_tile)
_MAX_D = 2125
_NARROW_MAX_D = 1024  # one thread a row of W: the narrow kernel, where it may be forced
_WIDE_MIN_D = 1025  # the wide variant's range, which the Python mirror covers
# K5's routes as csrc/admm_kernel.cu numbers them (0: the layout rule's)
ROUTES = {"narrow": 1, "cluster": 2, "stream": 3}
_ROUTE_NAMES = {v: k for k, v in ROUTES.items()}


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
    """Launch K5 (replaces the TPU's ``ops/admm_kernel.py:admm_chunk_pallas``)
    on the route the layout rule picks.  Every operand must be a float32,
    contiguous CUDA tensor: W (B, D, D), P (B, n, n), A (B, m, n) and the
    eight (B, D) vectors, D = n + m <= 2125.  Returns ``(s, yp, stats)``."""
    return _admm_chunk_launch(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, alpha=alpha,
                              seg=seg)


def _admm_chunk_launch(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, *, alpha, seg,
                       lib=None, route=None, cluster=None):
    """One launch of K5 (``lib``: a kernel library other than the package's,
    as ``tools/kernel_ab.py`` passes; ``route`` (a key of :data:`ROUTES`)
    and ``cluster`` (blocks a problem): a choice in place of the layout
    rule's, for the card's tests and measurements; the C entry refuses one
    that does not fit at this shape)."""
    global admm_chunk_launches
    from sqp_solver_tpu_torch.ops.qp_kernel import _check_cuda_operands, _ptr, _raise_on

    name = "admm_chunk_kernel"
    vecs = dict(qv=qv, scale1=scale1, rhoip=rhoip, rhop=rhop, lp=lp, up=up, s=s, yp=yp)
    batch, n, m = _check(name, W, P, A, vecs)
    dev = _check_cuda_operands(name, dict(W=W, P=P, A=A, **vecs), {})
    if n + m > _MAX_D:
        raise ValueError(f"{name}: D = n + m = {n + m} exceeds {_MAX_D}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"{name}: route {route!r} is not one of {tuple(ROUTES)}")
    if lib is None:
        from sqp_solver_tpu_torch.ops import _build

        lib = _build.load()
    s_out = torch.empty_like(s)
    yp_out = torch.empty_like(yp)
    stats = torch.empty((batch, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (_ptr(W), _ptr(P), _ptr(A), _ptr(qv), _ptr(scale1), _ptr(rhoip), _ptr(rhop),
            _ptr(lp), _ptr(up), _ptr(s), _ptr(yp), _ptr(s_out), _ptr(yp_out), _ptr(stats),
            batch, n, m, float(alpha), float(1.0 - alpha), int(seg), dev.index,
            ctypes.c_void_p(stream))
    taken = ctypes.c_int(0)
    if not hasattr(lib, "admm_chunk_route_layout"):  # a library before the routes
        if route is not None or cluster:
            raise ValueError(f"{name}: this library has no routes to force")
        rc = lib.admm_chunk_launch(*args)
    else:
        c = int(cluster or 0)
        if batch > 0 and (route is not None or c):  # raises, unlaunched, where it does not fit
            admm_chunk_layout(n, m, batch, route, c, device=dev, lib=lib)
        rc = lib.admm_chunk_launch_as(ROUTES.get(route, 0), c, *args, ctypes.byref(taken))
    _raise_on(lib, rc, name)
    admm_chunk_launches += 1
    if taken.value:
        key = _ROUTE_NAMES[taken.value]
        _route_launches[key] = _route_launches.get(key, 0) + 1
    return s_out, yp_out, stats


def route_counts() -> dict:
    """K5's launches by the route each took (``narrow``, ``cluster``,
    ``stream``) since :func:`reset_route_counts`."""
    return {k: _route_launches.get(k, 0) for k in ROUTES}


def reset_route_counts() -> None:
    _route_launches.clear()


def admm_chunk(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, *, alpha, seg):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    args = (W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp)
    if s.is_cuda:
        return admm_chunk_kernel(*args, alpha=alpha, seg=seg)
    _check("admm_chunk", W, P, A, dict(qv=qv, scale1=scale1, rhoip=rhoip, rhop=rhop,
                                        lp=lp, up=up, s=s, yp=yp))
    return admm_chunk_reference(*args, alpha=alpha, seg=seg)


def admm_chunk_smem_rows(n: int, m: int, batch: int = 1) -> int:
    """Rows of W that K5 holds in shared memory for the whole chunk at this
    shape, over all the blocks of a problem."""
    return admm_chunk_layout(n, m, batch)["smem_rows"]


# the fields of csrc/admm_kernel.cu:admm_chunk_route_layout, in its order
_LAYOUT_KEYS = ("route", "cluster", "threads", "blocks_per_sm", "smem_bytes", "rows_max",
                "smem_rows", "register_rows", "device_rows", "stages", "rows_stage",
                "stage_floats", "resident", "prow_max", "active_clusters")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def admm_chunk_layout(n: int, m: int, batch: int = 1, route=None, cluster: int = 0,
                      device=None, lib=None) -> dict:
    """K5's layout at this shape and batch on the card (its SM count from
    ``device``), as the kernel's one layout rule picks it
    (``csrc/admm_kernel.cu:route_layout``; ``route`` and ``cluster`` force a
    choice, as ``_admm_chunk_launch`` does): the route (narrow, cluster or
    stream), the blocks a problem (``cluster``), the rows of W a block
    holds or streams at most (``rows_max``), and where the D = n + m rows of
    W are: in shared memory for the whole chunk (``smem_rows``, over the
    problem's blocks), in registers (``register_rows``), or read from device
    memory every iteration (``device_rows``; ``w_bytes_per_iteration`` a
    problem); the shared memory a block, the ring's stages (the stream and
    cluster routes), ``resident``: the blocks an SM the runtime can hold of
    the kernel at that shared memory, and ``active_clusters``: the clusters
    the card can hold at once (0 on the narrow route).  Raises where the
    choice does not fit.  A library built before the routes (``lib``, a
    parent tree's) reports its one block a problem up to D = 1024 and the
    wide variant past it."""
    from sqp_solver_tpu_torch.ops import _build
    from sqp_solver_tpu_torch.ops.qp_kernel import _raise_on

    D = n + m
    if D > _MAX_D:
        raise ValueError(f"admm_chunk_layout: D = n + m = {D} exceeds {_MAX_D}")
    lib = lib or _build.load()
    if not hasattr(lib, "admm_chunk_route_layout"):
        if D > _NARROW_MAX_D:
            keys = ("cluster", "threads", "stages", "stage_floats", "rows_stage", "smem_bytes",
                    "blocks_per_sm", "resident", "rows_max", "prow_max")
            out = (ctypes.c_longlong * len(keys))()
            _raise_on(lib, int(lib.admm_chunk_wide_layout(
                n, m, batch, cluster, _sms(device or torch.device("cuda")), out)),
                "admm_chunk_wide_layout")
            return dict(zip(keys, (int(v) for v in out)), route="stream", smem_rows=0,
                        register_rows=0, device_rows=D, w_bytes_per_iteration=4 * D * D)
        smem, reg = int(lib.admm_chunk_smem_rows(n, m)), int(lib.admm_chunk_reg_rows(n, m))
        return dict(route="narrow", cluster=1, smem_rows=smem, register_rows=reg,
                    device_rows=D - smem - reg, w_bytes_per_iteration=4 * D * (D - smem - reg))
    device = device or torch.device("cuda")
    out = (ctypes.c_longlong * len(_LAYOUT_KEYS))()
    rc = int(lib.admm_chunk_route_layout(n, m, batch, ROUTES[route] if route else 0,
                                         int(cluster), _sms(device), out))
    if rc == 1:
        raise ValueError(f"admm_chunk_layout: route {route or 'of the rule'}, cluster "
                         f"{cluster or 'of the rule'} does not fit n = {n}, m = {m}, B = {batch}")
    _raise_on(lib, rc, "admm_chunk_layout")
    lay = dict(zip(_LAYOUT_KEYS, (int(v) for v in out)))
    lay["route"] = _ROUTE_NAMES[lay["route"]]
    lay.update(sms=_sms(device), w_bytes_per_iteration=4 * D * lay["device_rows"])
    return lay


# The wide variant's constants (csrc/admm_kernel.cu): consumer warps (and
# the ring's stages, one a warp), one producer warp, clusters, shared memory
_CLUSTERS = (1, 2, 4, 8)
_WIDE_WARPS = 8
_WIDE_THREADS = 32 * (_WIDE_WARPS + 1)
_SMEM_PER_SM = 233472
_SMEM_PER_BLOCK = 232448
_SMEM_RESERVED = 1024
_WIDE_BAR_BYTES = -(-(2 * _WIDE_WARPS + 5) * 8 // 128) * 128


def admm_chunk_wide_layout(n: int, m: int, batch: int, cluster: int = 0, sms: int = 132) -> dict:
    """The wide variant's layout (D = n + m from 1025 to 2125) for ``batch``
    problems on a card of ``sms`` SMs, as ``csrc/admm_kernel.cu:wide_layout``
    computes it: ``cluster`` blocks a problem (``cluster`` > 0 forces it;
    the rule takes the most, up to 8, for which ``batch * cluster`` blocks
    each have an SM of their own), block r holding the rows [r D / cluster, (r + 1) D / cluster)
    of W (``row_ranges``); ``blocks_per_sm`` 2 where the blocks outnumber
    the SMs, else 1; ``stages`` stages of ``rows_stage`` whole rows of W
    (``stage_bytes``) in the shared memory left beside the vectors
    (``smem_bytes`` a block).  Every row of W streams from device memory
    every iteration (``device_rows`` = D, ``w_bytes_per_iteration`` a
    problem).  Raises where the shape is not the wide variant's."""
    D = n + m
    if n <= 0 or m <= 0 or not _WIDE_MIN_D <= D <= _MAX_D or batch <= 0:
        raise ValueError(f"admm_chunk_wide_layout: n = {n}, m = {m}, B = {batch}: the wide "
                         f"variant takes D from {_WIDE_MIN_D} to {_MAX_D}")
    if cluster == 0:
        cluster = 1
        while cluster < _CLUSTERS[-1] and 2 * batch * cluster <= sms:
            cluster *= 2
    if cluster not in _CLUSTERS:
        raise ValueError(f"admm_chunk_wide_layout: cluster {cluster} not one of {_CLUSTERS}")
    rows_max, prow_max = -(-D // cluster), -(-n // cluster)
    vec = 4 * D + rows_max + (1 + cluster) * prow_max + 8 * _WIDE_WARPS + 8 * cluster
    vec = -(-vec // 4) * 4
    per_sm = 2 if batch * cluster > sms else 1
    while True:
        budget = _SMEM_PER_SM // 2 - _SMEM_RESERVED if per_sm == 2 else _SMEM_PER_BLOCK
        sf = ((budget - _WIDE_BAR_BYTES) // 4 - vec) // _WIDE_WARPS // 4 * 4
        rows_stage = (sf - 8) // D if sf > 8 else 0
        if rows_stage >= 1 or per_sm == 1:
            break
        per_sm = 1
    stage_floats = -(-(rows_stage * D + 8) // 4) * 4
    return dict(cluster=cluster, threads=_WIDE_THREADS, stages=_WIDE_WARPS,
                stage_floats=stage_floats, stage_bytes=4 * stage_floats, rows_stage=rows_stage,
                smem_bytes=_WIDE_BAR_BYTES + 4 * (_WIDE_WARPS * stage_floats + vec),
                blocks_per_sm=per_sm, blocks=batch * cluster, rows_max=rows_max,
                prow_max=prow_max,
                row_ranges=[(D * r // cluster, D * (r + 1) // cluster) for r in range(cluster)],
                device_rows=D, w_bytes_per_iteration=4 * D * D)
