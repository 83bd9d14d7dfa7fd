"""The batch split over devices (twin of ``sqp_solver_tpu/parallel/sharding.py``).

Solves never communicate, so a batch spread over several cards is plain
data parallelism: axis 0 of every batched tensor (the problem's params
too) is split into one shard a device, each shard runs the tier ``impl``
names on its device, and the results are concatenated on the device of
the input, with no collective.  A mesh is the tuple of devices.

The shards run one after another from this thread.  Every tier asks the
host during its solve (the per-problem and fused tiers every trip, the
kernel tiers when they read their statuses), so the devices overlap only
up to each shard's first such check: the split spreads a batch's memory
over the cards, it is not a throughput gain.  Threads, one a device,
would overlap them, but ``torch.func``'s forward-mode AD (``jacfwd``,
``hessian``, used where a problem has no derivative hooks) keeps one
dual level for the whole process, and two solves in two threads then
compute each other's derivatives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu_torch.qp.types import QPResult, QPSettings, QuadraticProblem
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings

__all__ = [
    "make_mesh",
    "shard_batch",
    "sharded_qp_solve_batch",
    "sharded_sqp_solve_batch",
]


def make_mesh(devices: Optional[Sequence] = None) -> Tuple[torch.device, ...]:
    """The devices to split a batch over: the given ones, or every CUDA
    device; raises where there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass the devices to split over")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: no device given")
    return mesh


def shard_batch(t: torch.Tensor, mesh: Sequence[torch.device]) -> list:
    """Axis 0 of ``t`` in one near-equal shard a device of ``mesh``, each
    on its device."""
    if t.shape[0] < len(mesh):
        raise ValueError(f"shard_batch: a batch of {t.shape[0]} over {len(mesh)} devices")
    return [s.to(d) for s, d in zip(torch.tensor_split(t, len(mesh), dim=0), mesh)]


def _concat(parts: list, device: torch.device):
    """Shard results joined into one on ``device``: tensors on their batch
    axis 0, the record-trace dicts (max_iter, B, ...) on axis 1."""
    head = parts[0]
    if head is None:
        return None
    if torch.is_tensor(head):
        return torch.cat([p.to(device) for p in parts], dim=0)
    if isinstance(head, dict):
        return {k: torch.cat([p[k].to(device) for p in parts], dim=1) for k in head}
    return type(head)(**{f.name: _concat([getattr(p, f.name) for p in parts], device)
                         for f in dataclasses.fields(head)})


def sharded_qp_solve_batch(qp: QuadraticProblem, settings: QPSettings = QPSettings(),
                           mesh: Optional[Sequence[torch.device]] = None,
                           impl: str = "vmap") -> QPResult:
    """``qp_solve_batch(qp, settings, impl=impl)`` with the batch split
    over ``mesh`` (by default every CUDA device)."""
    mesh = make_mesh() if mesh is None else mesh
    leaves = [shard_batch(getattr(qp, k), mesh) for k in ("P", "q", "A", "l", "u")]
    parts = [qp_solve_batch(QuadraticProblem(*shard), settings, impl=impl)
             for shard in zip(*leaves)]
    return _concat(parts, qp.q.device)


def sharded_sqp_solve_batch(problem: NonlinearProblem, x0: torch.Tensor,
                            lam0: Optional[torch.Tensor] = None,
                            settings: SQPSettings = SQPSettings(),
                            mesh: Optional[Sequence[torch.device]] = None,
                            impl: str = "vmap") -> SQPResult:
    """``sqp_solve_batch(problem, x0, lam0, settings, impl=impl)`` with the
    batch split over ``mesh`` (by default every CUDA device).  Batched
    bounds ((B, m)) and params (a tensor with a leading B) are split with
    x0; shared bounds ((m,)) are copied to every device."""
    mesh = make_mesh() if mesh is None else mesh
    k = len(mesh)
    batched_bounds = problem.l.dim() == x0.dim()

    def split(t, batched):
        if t is None:
            return [None] * k
        return shard_batch(t, mesh) if batched else [t.to(d) for d in mesh]

    ls, us = split(problem.l, batched_bounds), split(problem.u, batched_bounds)
    ps = split(problem.params, True)
    xs, lams = split(x0, True), split(lam0, True)
    parts = [sqp_solve_batch(dataclasses.replace(problem, l=l, u=u, params=p), x, lam,
                             settings, impl=impl)
             for l, u, p, x, lam in zip(ls, us, ps, xs, lams)]
    return _concat(parts, x0.device)
