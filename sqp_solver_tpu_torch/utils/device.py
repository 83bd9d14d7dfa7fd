"""The device a generator or constructor puts its tensors on by default.

The port is for the card: generators and constructors that take a
``device`` put their tensors on the CUDA device unless the caller names
another (``device="cpu"``, as the CPU tests do).  Solver entry points
need no default: they run on the device of their inputs.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises where no CUDA device is present
    rather than returning the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package's tensors go to the card by default; "
            "pass device='cpu' to run its plain versions on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` when None."""
    return default_device() if device is None else torch.device(device)
