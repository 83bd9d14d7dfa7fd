"""k6_band_roofline: the wide K6's share of its roofline on the band route
(``qp_btd_wide_kernel``), the work counted at the declared stage block."""

from perfbench.metrics import _counts


def read(rec):
    return _counts.roofline(rec, "qp_btd_wide_kernel", _counts.btd_counts)
