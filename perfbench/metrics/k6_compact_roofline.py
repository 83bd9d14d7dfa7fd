"""k6_compact_roofline: the wide K6's share of its roofline on the compact
route past internal block 128 (``qp_btd_xwide_kernel``), the work counted
at the declared stage block."""

from perfbench.metrics import _counts


def read(rec):
    return _counts.roofline(rec, "qp_btd_xwide_kernel", _counts.btd_counts)
