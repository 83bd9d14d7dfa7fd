"""admm.iters_mean: mean ADMM iterations a problem over the traced window's
answers (``QPResult.info.iter``), ADMM solver layer."""

import torch


def read(rec):
    if rec.trace is None:
        return None
    return float(torch.cat([r.info.iter for r in rec.results]).double().mean())
