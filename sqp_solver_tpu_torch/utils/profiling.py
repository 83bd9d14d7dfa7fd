"""Timing, tracing and solve summaries (twin of
``sqp_solver_tpu/utils/profiling.py``): a wall clock closed by a device
synchronize, a ``torch.profiler`` trace around a block, and a compact
dict of a batch's statuses, iterations and residuals."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["time_solve", "trace", "summarize_info"]


def time_solve(fn: Callable, *args, reps: int = 3, **kwargs):
    """Best wall seconds of ``reps`` calls of ``fn(*args, **kwargs)`` after
    one warm-up call, each closed by ``torch.cuda.synchronize()`` on every
    card there is.  Returns ``(best_seconds, last_result)``."""

    def sync():
        if torch.cuda.is_available():
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)

    out = fn(*args, **kwargs)
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir: str = None):
    """A ``torch.profiler`` profile of the block (CPU and, where present,
    CUDA activity), yielded for ``key_averages()``; on exit its Chrome
    trace is written to ``log_dir/trace.json`` (by default under the
    temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "sqp_solver_tpu_torch_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def summarize_info(info) -> Dict[str, Any]:
    """A batch's diagnostics as a compact dict: status counts, solved
    share, iteration percentiles and the residuals' medians (the JAX
    package's keys)."""

    def arr(v, dtype=None):
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        return np.atleast_1d(v if dtype is None else v.astype(dtype))

    out: Dict[str, Any] = {}
    status = arr(info.status)
    out["n"] = int(status.size)
    vals, counts = np.unique(status, return_counts=True)
    out["status_counts"] = {int(v): int(c) for v, c in zip(vals, counts)}
    out["solved_frac"] = float(np.mean(status == 0))
    iters = arr(info.iter)
    out["iter_p50"] = float(np.percentile(iters, 50))
    out["iter_p99"] = float(np.percentile(iters, 99))
    for field in ("res_prim", "res_dual", "primal_step_norm", "dual_step_norm"):
        if hasattr(info, field):
            out[f"{field}_p50"] = float(np.percentile(arr(getattr(info, field), np.float64), 50))
    return out
