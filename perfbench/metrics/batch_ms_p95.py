"""batch_ms_p95: the 95th percentile of the wall of one batch call (host
clock, closed by ``torch.cuda.synchronize()``) over every call of the
window, in ms (Python's inclusive quantiles)."""

import statistics


def read(rec):
    if len(rec.walls) < 2:
        return None
    return statistics.quantiles([w * 1e3 for w in rec.walls], n=20, method="inclusive")[18]
