"""Carrying problem data and solver state across from the JAX package.

A solver has no weights: what crosses over is problem data and solver
state, as numpy arrays (``np.asarray`` of a JAX array), onto ``device``
(by default the card; ``device="cpu"`` for the plain versions).  The JAX kernels
keep the batch LAST (``(..., B)``, problems on the TPU lanes); this
package keeps it first.  Callables cannot cross over, so a problem family
is rebuilt from its data.
"""

from __future__ import annotations

import numpy as np
import torch

from sqp_solver_tpu_torch.models.benchmark import sphere_cap_problem
from sqp_solver_tpu_torch.models.mpc import mpc_nlp_stagewise_problem
from sqp_solver_tpu_torch.qp.scaling import Scaling
from sqp_solver_tpu_torch.qp.types import QPResult, QPState, QuadraticProblem
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = [
    "from_kernel_layout",
    "to_kernel_layout",
    "qp_state_from_numpy",
    "hessian_from_numpy",
    "sphere_cap_from_arrays",
    "mpc_nlp_from_arrays",
    "band_from_kernel_layout",
    "band_to_kernel_layout",
    "qp_from_arrays",
    "qp_result_to_numpy",
    "scaling_from_numpy",
]


def _tensor(a, dtype, device):
    # a copy: arrays from JAX are read-only
    return torch.as_tensor(np.array(a), dtype=dtype).to(resolve_device(device))


def from_kernel_layout(a, dtype=None, device=None) -> torch.Tensor:
    """A (..., B) array of the JAX kernel layout as a (B, ...) tensor."""
    return _tensor(np.moveaxis(np.asarray(a), -1, 0), dtype, device)


def to_kernel_layout(t: torch.Tensor) -> np.ndarray:
    """A (B, ...) tensor as a (..., B) array of the JAX kernel layout."""
    return np.ascontiguousarray(np.moveaxis(t.detach().cpu().numpy(), 0, -1))


def qp_state_from_numpy(x, z, y, dtype=None, device=None) -> QPState:
    """A batch-first QP warm start from (B, n), (B, m), (B, m) arrays."""
    return QPState(x=_tensor(x, dtype, device), z=_tensor(z, dtype, device),
                   y=_tensor(y, dtype, device))


def hessian_from_numpy(Bt, dtype=None, device=None) -> torch.Tensor:
    """The JAX kernel tier's BFGS state (n, n, B) as a (B, n, n) tensor."""
    return from_kernel_layout(Bt, dtype, device)


def sphere_cap_from_arrays(l, u, r, dtype=None, device=None) -> NonlinearProblem:
    """A sphere-cap problem from a JAX problem's leaves: ``l``, ``u``
    (B, n + 1) and ``params`` (the radii, (B,))."""
    return sphere_cap_problem(
        _tensor(l, dtype, device), _tensor(u, dtype, device), _tensor(r, dtype, device)
    )


def band_from_kernel_layout(a, dtype=None, device=None) -> torch.Tensor:
    """A band of the JAX structured kernels, (n, bb, B) with rows
    [k bb, (k+1) bb) the k-th block, as the port's (B, T, bb, bb)."""
    a = np.moveaxis(np.asarray(a), -1, 0)
    B, n, bb = a.shape
    return _tensor(a.reshape(B, n // bb, bb, bb), dtype, device)


def band_to_kernel_layout(t: torch.Tensor) -> np.ndarray:
    """A (B, T, bb, bb) band as the JAX structured kernels' (n, bb, B)."""
    B, T, bb, _ = t.shape
    return to_kernel_layout(t.reshape(B, T * bb, bb))


def mpc_nlp_from_arrays(l, u, params, horizon: int, dtype=None, device=None,
                        **weights) -> NonlinearProblem:
    """The unicycle family (``models.mpc.mpc_nlp_stagewise_batch``) from a
    JAX problem's leaves: ``l``, ``u`` (B, 7 T) and ``params`` (B, 5).
    ``weights`` (dt, speed, q_weight, r_weight, th_weight) where the
    generator's defaults were changed."""
    return mpc_nlp_stagewise_problem(
        _tensor(l, dtype, device), _tensor(u, dtype, device),
        _tensor(params, dtype, device), horizon, **weights)


def qp_from_arrays(P, q, A, l, u, dtype=None, device=None) -> QuadraticProblem:
    """A batch-first QP from a JAX ``QuadraticProblem``'s leaves (P (B, n, n),
    q (B, n), A (B, m, n), l and u (B, m)), which are batch-first as well."""
    return QuadraticProblem(*(_tensor(a, dtype, device) for a in (P, q, A, l, u)))


def qp_result_to_numpy(result: QPResult) -> dict:
    """A QP result as numpy arrays: x, y, z and the info fields by name."""
    out = {k: getattr(result, k).detach().cpu().numpy() for k in ("x", "y", "z")}
    for k in ("status", "iter", "rho_updates", "rho_estimate", "res_prim", "res_dual"):
        out[k] = getattr(result.info, k).detach().cpu().numpy()
    return out


def scaling_from_numpy(d, e, c, dtype=None, device=None) -> Scaling:
    """A :class:`~sqp_solver_tpu_torch.qp.scaling.Scaling` from a JAX
    ``Scaling``'s leaves, batch-first: d (B, n), e (B, m), c (B,)."""
    return Scaling(d=_tensor(d, dtype, device), e=_tensor(e, dtype, device),
                   c=_tensor(c, dtype, device))
