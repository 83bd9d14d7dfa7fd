"""entry.device_ms: device ms per batch call in operations that are not a
hand-written kernel of the program: padding, band extraction, masks,
status (QP entry layer)."""

from perfbench.metrics import _counts


def read(rec):
    if rec.trace is None:
        return None
    ms = _counts.device_ms(rec, lambda name, kern: not (kern and _counts.is_handwritten(rec, name)))
    return ms / _counts.calls(rec)
