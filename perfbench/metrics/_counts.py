"""The yardstick of the per-layer readers: the card's peaks, the work
(operations and bytes) that a call's inputs need in each kernel, and the
reductions of a traced window that several readers share.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.  A
kernel's bound is the larger of its operations over the first and its
bytes over the second; its roofline share is the bound over the time it
took.  Operations are counted at the iterations each problem took; bytes
are each operand read once and each output written once."""

from __future__ import annotations

import math
import re

import torch

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def _nonzeros(rec, k: int) -> tuple:
    """Per problem of pool batch ``k``: A's nonzeros and the sum over A's
    rows of their nonzeros squared (kept on the record)."""
    cache = rec.__dict__.setdefault("_nonzeros", {})
    if k not in cache:
        nz = (rec.pool[k]["A"] != 0).double()
        cache[k] = (nz.sum((1, 2)), (nz.sum(2) ** 2).sum(1))
    return cache[k]


def _schedule(s) -> tuple:
    """(iterations a check, checks a rho epoch) of the settings ``s``."""
    seg = s.check_termination if s.check_termination > 0 else s.max_iter
    interval = s.adaptive_rho_interval if s.adaptive_rho else s.max_iter
    return seg, max(1, -(-min(interval, s.max_iter) // seg))


def btd_counts(rec, k: int, info) -> tuple:
    """(operations, bytes) of one structured solve of pool batch ``k`` at
    the configuration's declared stage block b (not the kernel's internal
    block), from the problem's data: per ADMM iteration 2 (4 n b + 2 nnz(A))
    (the block-tridiagonal solves and A's two products), per factorization
    2 (3 n b^2 + sum over rows of nnz_r^2) (one per adopted rho, at most one
    an epoch); read once: P's band (2 n b), A's nonzeros, q, l, u and the
    start (x, z, y); written once: x, z, y."""
    A = rec.pool[k]["A"]
    _, m, n = A.shape
    b = rec.cfg["stage_block"]
    nnz, gram = _nonzeros(rec, k)
    seg, cpe = _schedule(rec.settings)
    it = info.iter.double()
    epochs = torch.clamp_min(torch.ceil(it / (cpe * seg)), 1)
    nfact = torch.minimum(info.rho_updates.double(), epochs) * (it > 0)
    flops = 2 * (4 * n * b + 2 * nnz) * it + 2 * (3 * n * b * b + gram) * nfact
    floats = 2 * n * b + nnz + (n + 2 * m) * 3
    return float(flops.sum()), float(floats.sum()) * 4


def calls(rec) -> int:
    return len(rec.walls)


def device_ms(rec, keep) -> float:
    """Device milliseconds of the traced window's operations for which
    ``keep(name, kernel)`` holds."""
    return sum(e - s for name, s, e, kern in rec.trace.ops if keep(name, kern)) * 1e-3


def is_handwritten(rec, name: str) -> bool:
    cache = rec.__dict__.setdefault("_handwritten", {})
    if name not in cache:
        cache[name] = bool(set(re.findall(r"\w+", name)) & set(rec.handwritten))
    return cache[name]


def roofline(rec, kernel: str, counts) -> float | None:
    """100 x the bound over the device time of the hand-written kernel
    ``kernel`` (by its name) in the traced window; None where it did not run."""
    if rec.trace is None:
        return None
    ms = device_ms(rec, lambda name, kern: kern and kernel in re.findall(r"\w+", name))
    if ms <= 0:
        return None
    flops = nbytes = 0.0
    for k, res in zip(rec.order, rec.results):
        f, b = counts(rec, k, res.info)
        flops, nbytes = flops + f, nbytes + b
    share = 100.0 * bound_ms(flops, nbytes) / ms
    return share if math.isfinite(share) else None
