"""device.idle_share: 100 (1 - the union of the device operations' intervals
over the traced window's length), device layer."""

from perfbench.harness import busy_intervals


def read(rec):
    if rec.trace is None:
        return None
    w0, w1 = rec.trace.window
    busy = sum(e - s for s, e in busy_intervals(rec.trace))
    return 100.0 * (1.0 - busy / (w1 - w0))
