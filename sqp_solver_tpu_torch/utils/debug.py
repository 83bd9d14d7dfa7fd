"""Debug printers (twin of ``sqp_solver_tpu/utils/debug.py``): the
reference's ``print_qp`` and ``is_psd`` (``include/solvers/utils.hpp``;
this ``is_psd`` has no dynamic-size bug) and the settings and info dumps
the reference gates behind ``verbose`` (``qp.hpp:56-66, 82-106``,
``sqp.hpp:40-59``).  Tensors print from the host, in numpy's format."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

__all__ = ["print_qp", "is_psd", "print_settings", "print_info"]


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def print_qp(qp) -> None:
    """Print a QuadraticProblem's fields (reference utils.hpp:8-17)."""
    for name in ("P", "q", "A", "l", "u"):
        print(f"{name} =\n{_np(getattr(qp, name))}")


def is_psd(H) -> bool:
    """Whether every eigenvalue of the symmetric H is >= 0 (reference
    utils.hpp:19-30)."""
    return bool(np.all(np.linalg.eigvalsh(_np(H)) >= 0))


def print_settings(settings, file=None) -> None:
    """One line a field (reference ``QPSolverSettings::print``,
    qp.hpp:56-66; the SQP settings in the same format), nested settings
    (``SQPSettings.qp``) indented."""
    file = file or sys.stdout
    print(f"{type(settings).__name__}:", file=file)
    for f in dataclasses.fields(settings):
        v = getattr(settings, f.name)
        if dataclasses.is_dataclass(v):
            print(f"  {f.name}:", file=file)
            for g in dataclasses.fields(v):
                print(f"    {g.name} = {getattr(v, g.name)}", file=file)
        elif callable(v):
            print(f"  {f.name} = <callable {getattr(v, '__name__', repr(v))}>", file=file)
        else:
            print(f"  {f.name} = {v}", file=file)


def print_info(info, file=None) -> None:
    """Info dump (reference ``QPSolverInfo::print`` qp.hpp:82-106 and
    ``sqp::Info`` sqp.hpp:40-59): the status by name, from the status
    enum; a batched field as counts a status and percentiles."""
    from sqp_solver_tpu_torch.qp.types import QPStatus
    from sqp_solver_tpu_torch.sqp.types import SQPStatus

    file = file or sys.stdout
    enum_cls = SQPStatus if hasattr(info, "qp_solver_iter") else QPStatus
    names = {int(s): s.name for s in enum_cls}
    status = _np(info.status)
    print(f"{type(info).__name__}:", file=file)
    if status.ndim == 0:
        print(f"  status = {names.get(int(status), int(status))}", file=file)
    else:
        for code, label in names.items():
            cnt = int((status == code).sum())
            if cnt:
                print(f"  status[{label}] = {cnt}/{status.size}", file=file)
    for f in dataclasses.fields(info):
        if f.name == "status":
            continue
        v = _np(getattr(info, f.name))
        if v.ndim == 0:
            print(f"  {f.name} = {v}", file=file)
        else:
            print(f"  {f.name}: p50 = {np.percentile(v, 50):.3g}, "
                  f"p99 = {np.percentile(v, 99):.3g}, max = {v.max():.3g}", file=file)
