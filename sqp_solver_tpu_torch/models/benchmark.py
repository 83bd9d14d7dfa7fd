"""Benchmark NLP families (twin of ``sqp_solver_tpu/models/benchmark.py``).

* The flagship sphere cap,

      min -sum(x)   s.t.   ||x||^2 <= r_b^2,   0 <= x <= 1,

  with the closed-form optimum x* = min(1, r_b / sqrt(n)) * 1.  Its data
  are drawn with the same numpy calls in the same order as the JAX
  package, so one seed gives the identical problem in both packages.
* Two multi-outer families without a closed form, each certified by an
  independent float64 evaluation of its KKT residuals: the
  ball-constrained Rosenbrock (:func:`rosenbrock_nlp_batch_device`,
  :func:`rosenbrock_kkt_residuals`) and the exponential chain
  (:func:`exp_chain_nlp_batch_device`, :func:`exp_chain_kkt_residuals`).
  Their ``_device`` generators draw from a ``torch.Generator``: the JAX
  package's distributions, not its draws.  :func:`rosenbrock_problem` and
  :func:`exp_chain_problem` build a problem from given data, such as the
  JAX package's draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sqp_solver_tpu_torch.models.families import _draws, _generator
from sqp_solver_tpu_torch.models.mpc import _f64
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = [
    "sphere_cap_nlp_batch",
    "sphere_cap_problem",
    "sphere_cap_solution",
    "rosenbrock_problem",
    "rosenbrock_nlp_batch_device",
    "rosenbrock_kkt_residuals",
    "exp_chain_problem",
    "exp_chain_nlp_batch_device",
    "exp_chain_kkt_residuals",
]


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


def _ball_box(x, params):
    """c(x) = [x'x; x]: the budget ball and the box."""
    del params
    return torch.cat([(x * x).sum(-1, keepdim=True), x], dim=-1)


def _ball_box_bounds(r, lo: float, hi: float, batch: int, n: int, dtype, device):
    full = dict(dtype=dtype, device=device)
    l = torch.cat([torch.zeros((batch, 1), **full), torch.full((batch, n), lo, **full)], dim=1)
    u = torch.cat([(r * r).unsqueeze(-1), torch.full((batch, n), hi, **full)], dim=1)
    return l, u


def _rosenbrock_objective(x, params):
    del params
    d = x[..., 1:] - x[..., :-1] ** 2
    return (100.0 * d * d).sum(-1) + ((1.0 - x[..., :-1]) ** 2).sum(-1)


def rosenbrock_problem(l: torch.Tensor, u: torch.Tensor, r: torch.Tensor) -> NonlinearProblem:
    """The ball-constrained Rosenbrock from its data: l, u (B, n + 1), radii
    r (B,)."""
    return NonlinearProblem(l=l, u=u, params=r, objective=_rosenbrock_objective,
                            constraint=_ball_box)


def rosenbrock_nlp_batch_device(gen, batch: int, n: int, dtype=torch.float32, device=None):
    """Batched ball-constrained Rosenbrock NLP drawn on the device:

        min sum_i 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2
        s.t. ||x||^2 <= r_b^2,   -2 <= x <= 2,

    radii r in [0.6 sqrt(n), 0.85 sqrt(n)], so the ball is active at the
    solution, from the staggered start (-1.2, 1, -1.2, ...) plus U(0, 0.05).
    ``gen`` is a ``torch.Generator`` (its device is the problems') or an
    integer seed for one on ``device`` (by default the card).  Returns
    ``(problem, x0)``; certify with :func:`rosenbrock_kkt_residuals`."""
    _, uniform = _draws(_generator(gen, device), dtype)
    sqn = math.sqrt(n)
    r = 0.6 * sqn + 0.25 * sqn * uniform(batch)
    l, u = _ball_box_bounds(r, -2.0, 2.0, batch, n, dtype, r.device)
    base = torch.ones(n, dtype=dtype, device=r.device)
    base[::2] = -1.2
    x0 = base + 0.05 * uniform(batch, n)
    return rosenbrock_problem(l, u, r), x0


def _kkt_ball_box(problem, x, lam, g):
    """(primal_viol, dual_res) of c = [x'x; x] with the exact gradient g."""
    st = g + 2.0 * lam[:, 0:1] * x + lam[:, 1:]
    dual_res = np.abs(st).max(axis=1)
    r2 = _f64(problem.u[:, 0])
    lo, hi = _f64(problem.l[:, 1:]), _f64(problem.u[:, 1:])
    ball = np.maximum(np.sum(x * x, axis=1) - r2, 0.0)
    box = np.maximum(np.maximum(x - hi, lo - x), 0.0).max(axis=1)
    return np.maximum(ball, box), dual_res


def rosenbrock_kkt_residuals(problem, x, lam):
    """Float64 KKT residuals of the Rosenbrock family in numpy, no solver
    code: per problem (primal violation of the ball and the box,
    stationarity ||grad f + J' lam||_inf with the exact gradient)."""
    x, lam = _f64(x), _f64(lam)
    d = x[:, 1:] - x[:, :-1] ** 2
    g = np.zeros_like(x)
    g[:, :-1] += -400.0 * d * x[:, :-1] - 2.0 * (1.0 - x[:, :-1])
    g[:, 1:] += 200.0 * d
    return _kkt_ball_box(problem, x, lam, g)


def _exp_chain_objective(x, p):
    n = x.shape[-1]
    cc, bb = p[..., :n], p[..., n:]
    d = x[..., 1:] - x[..., :-1]
    return (torch.exp(cc * x) - bb * x).sum(-1) + 0.5 * (d * d).sum(-1)


def exp_chain_problem(l: torch.Tensor, u: torch.Tensor, params: torch.Tensor) -> NonlinearProblem:
    """The exponential chain from its data: l, u (B, n + 1), params
    concat(c, b) (B, 2 n)."""
    return NonlinearProblem(l=l, u=u, params=params, objective=_exp_chain_objective,
                            constraint=_ball_box)


def exp_chain_nlp_batch_device(gen, batch: int, n: int, dtype=torch.float32, device=None):
    """Batched exponential-chain NLP drawn on the device:

        min sum_i exp(c_i x_i) - b_i x_i + 1/2 sum_i (x_{i+1} - x_i)^2
        s.t. ||x||^2 <= r_b^2,   -3 <= x <= 3,

    rates c in U(0.5, 1.5), prices b in U(1, 3), radii r in
    [0.35 sqrt(n), 0.6 sqrt(n)] (the ball active at the optimum), from
    x0 = 0.01 U(0, 1).  A strictly convex objective whose Lagrangian
    Hessian depends on x: damped BFGS needs some 20-35 outer iterations.
    ``gen`` as for :func:`rosenbrock_nlp_batch_device`.  Returns
    ``(problem, x0)`` with params = concat(c, b); certify with
    :func:`exp_chain_kkt_residuals`."""
    _, uniform = _draws(_generator(gen, device), dtype)
    sqn = math.sqrt(n)
    r = 0.35 * sqn + 0.25 * sqn * uniform(batch)
    c = 0.5 + uniform(batch, n)
    b = 1.0 + 2.0 * uniform(batch, n)
    l, u = _ball_box_bounds(r, -3.0, 3.0, batch, n, dtype, r.device)
    x0 = 0.01 * uniform(batch, n)
    return exp_chain_problem(l, u, torch.cat([c, b], dim=1)), x0


def exp_chain_kkt_residuals(problem, x, lam):
    """Float64 KKT residuals of the exponential chain in numpy, no solver
    code, as :func:`rosenbrock_kkt_residuals`."""
    x, lam = _f64(x), _f64(lam)
    p = _f64(problem.params)
    n = x.shape[1]
    c, b = p[:, :n], p[:, n:]
    g = c * np.exp(c * x) - b
    d = x[:, 1:] - x[:, :-1]
    g[:, :-1] -= d
    g[:, 1:] += d
    return _kkt_ball_box(problem, x, lam, g)
