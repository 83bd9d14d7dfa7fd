"""Flagship benchmark family (twin of the sphere-cap part of
``sqp_solver_tpu/models/benchmark.py``):

    min -sum(x)   s.t.   ||x||^2 <= r_b^2,   0 <= x <= 1

with the closed-form optimum x* = min(1, r_b / sqrt(n)) * 1.  The data are
drawn with the same numpy calls in the same order as the JAX package, so
one seed gives the identical problem in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from sqp_solver_tpu_torch.sqp.types import NonlinearProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = ["sphere_cap_nlp_batch", "sphere_cap_problem", "sphere_cap_solution"]


def _objective(x, params):
    del params
    return -x.sum(-1)


def _constraint(x, params):
    del params
    return torch.cat([(x * x).sum(-1, keepdim=True), x], dim=-1)


def _constraint_linearized(x, params):
    # c = [x'x; x]  =>  J = [2x'; I]
    del params
    B, n = x.shape
    eye = torch.eye(n, dtype=x.dtype, device=x.device).expand(B, n, n)
    return _constraint(x, None), torch.cat([2.0 * x.unsqueeze(1), eye], dim=1)


def _lagrangian_hessian(x, lam, params):
    # H_L = 2 lam_0 I (the objective is linear, the box rows are linear)
    del params
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    return eye * (2.0 * lam[:, 0])[:, None, None]


def sphere_cap_problem(l: torch.Tensor, u: torch.Tensor, r: torch.Tensor) -> NonlinearProblem:
    """The family's problem from its data: l, u (B, n + 1), radii r (B,)."""
    return NonlinearProblem(
        l=l, u=u, params=r,
        objective=_objective,
        constraint=_constraint,
        constraint_linearized=_constraint_linearized,
        lagrangian_hessian=_lagrangian_hessian,
    )


def sphere_cap_nlp_batch(batch: int, n: int, seed: int = 0, dtype=torch.float32,
                         device=None, r_range=(0.55, 0.9)):
    """Returns (problem with batched data on ``device``, x0 (B, n)).
    ``device`` defaults to the card (:func:`~sqp_solver_tpu_torch.utils.device.default_device`).

    ``r_range`` scales the radii relative to sqrt(n); the default keeps the
    sphere active and away from the degenerate r ~ sqrt(n) boundary."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    r = rng.uniform(r_range[0] * np.sqrt(n), r_range[1] * np.sqrt(n), size=(batch,))
    l = np.concatenate([np.zeros((batch, 1)), np.zeros((batch, n))], axis=1)
    u = np.concatenate([(r**2)[:, None], np.ones((batch, n))], axis=1)
    x0 = np.full((batch, n), 0.25) + rng.uniform(0, 0.05, size=(batch, n))

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return sphere_cap_problem(t(l), t(u), t(r)), t(x0)


def sphere_cap_solution(problem: NonlinearProblem) -> np.ndarray:
    """Closed-form optimum per batch element: min(1, r/sqrt(n)) * ones."""
    u0 = problem.u[:, 0].detach().cpu().numpy().astype(np.float64)
    r = np.sqrt(u0)
    n = problem.l.shape[1] - 1
    scale = np.minimum(1.0, r / np.sqrt(n))
    return np.broadcast_to(scale[:, None], (r.shape[0], n)) * np.ones((1, n))
