"""Host checks of the masked loops.

The per-problem tiers (``qp/admm.py``, ``sqp/solver.py``) run data-dependent
while loops as batch-first masked loops: each trip asks the device whether
any problem is still live, one synchronisation with the host.  The count of
those checks is kept here, so a run on the card can report it.
"""

from __future__ import annotations

import torch

__all__ = ["any_live", "host_checks"]

host_checks = 0


def any_live(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted as one host check."""
    global host_checks
    host_checks += 1
    return bool(mask.any())
