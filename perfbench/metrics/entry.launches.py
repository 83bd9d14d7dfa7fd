"""entry.launches: CUDA kernels launched per batch call in the traced window
(the profiler's kernels; copies and fills left out), QP entry layer."""

from perfbench.metrics import _counts


def read(rec):
    if rec.trace is None:
        return None
    return sum(1 for op in rec.trace.ops if op[3]) / _counts.calls(rec)
