"""Ruiz equilibration, problem prescaling for QPs (twin of
``sqp_solver_tpu/qp/scaling.py``).

The reference library re-implements OSQP's ADMM loop but drops OSQP's
problem scaling; on badly scaled data (the huber family,
:mod:`sqp_solver_tpu_torch.models.families`) the unscaled iteration stalls
far above tolerance, worse in float32.  This is modified Ruiz
equilibration of the KKT matrix [[P, A'], [A, 0]] with cost normalization
(the OSQP paper's section 5.1): variable i is scaled by 1 / sqrt(||KKT
column i||_inf), constraint j by 1 / sqrt(||row j of A||_inf), and the
cost so that ||grad f|| is O(1).  The scaled problem is

    P^ = c D P D,  q^ = c D q,  A^ = E A D,  l^ = E l,  u^ = E u

with diagonal D (n), E (m) and cost scalar c; solutions map back as
x = D x^, z = E^-1 z^, y = E y^ / c.

Batch-first, with optional leading batch dimensions: one equilibration
serves every tier, the kernel tiers included (the JAX package's
transposed twin ``ruiz_equilibrate_t`` exists only for its TPU kernel
layout).  The wrapped solver terminates on scaled residuals;
:func:`rescore` recomputes the true residuals on the original problem and
re-derives the status, so a scaled solve never reports SOLVED on a point
that misses the original tolerances.
"""

from __future__ import annotations

import dataclasses

import torch

from sqp_solver_tpu_torch.qp.classify import LOOSE_BOUNDS_THRESH, RHO_TOL
from sqp_solver_tpu_torch.qp.types import (
    QPInfo,
    QPResult,
    QPSettings,
    QPState,
    QPStatus,
    QuadraticProblem,
)

__all__ = [
    "Scaling",
    "ruiz_equilibrate",
    "scale_state",
    "unscale_result",
    "rescore",
    "solve_with_scaling",
]

# per-sweep clamp on the scaling factors (keeps pathological rows and
# columns from driving the cumulative scaling to extremes)
_MIN_SCALING = 1e-4
_MAX_SCALING = 1e4
_BIG = 1e20  # loose-bound sentinel, beyond LOOSE_BOUNDS_THRESH


@dataclasses.dataclass(frozen=True)
class Scaling:
    """Diagonal equilibration factors: x = d x^, constraint rows scaled by
    e, cost by the scalar c (per problem under leading batch dimensions)."""

    d: torch.Tensor  # (..., n)
    e: torch.Tensor  # (..., m)
    c: torch.Tensor  # (...,)


def _guard(delta):
    one = torch.ones((), dtype=delta.dtype, device=delta.device)
    return torch.clamp(torch.where(torch.isfinite(delta) & (delta > 0.0), delta, one),
                       _MIN_SCALING, _MAX_SCALING)


def _amax(v, dim):
    return v.abs().amax(dim=dim)


def ruiz_equilibrate(problem: QuadraticProblem, iters: int = 10):
    """Equilibrate a QP (one problem or leading batch dimensions).  Returns
    ``(scaled_problem, Scaling)``."""
    P, q, A, l, u = problem.P, problem.q, problem.A, problem.l, problem.u
    dtype, dev = P.dtype, P.device
    n = P.shape[-1]
    m = A.shape[-2]
    batch_shape = P.shape[:-2]
    zero = torch.zeros((), dtype=dtype, device=dev)

    loose_l = l <= -LOOSE_BOUNDS_THRESH
    loose_u = u >= LOOSE_BOUNDS_THRESH
    # the loose sentinels carry no scale information: zeroed during the
    # sweeps, restored afterwards
    l = torch.where(loose_l, zero, l)
    u = torch.where(loose_u, zero, u)

    d = torch.ones(batch_shape + (n,), dtype=dtype, device=dev)
    e = torch.ones(batch_shape + (m,), dtype=dtype, device=dev)
    c = torch.ones(batch_shape, dtype=dtype, device=dev)
    for _ in range(iters):
        # KKT column norms: variable column i spans |P[:, i]| and |A[:, i]|;
        # constraint column j spans |A[j, :]| (the A' block)
        col_norm = torch.maximum(_amax(P, -2), _amax(A, -2))  # (..., n)
        row_norm = _amax(A, -1)  # (..., m)
        dd = _guard(1.0 / torch.sqrt(col_norm))
        de = _guard(1.0 / torch.sqrt(row_norm))
        P = dd.unsqueeze(-1) * P * dd.unsqueeze(-2)
        q = q * dd
        A = de.unsqueeze(-1) * A * dd.unsqueeze(-2)
        l = l * de
        u = u * de
        # cost normalization (OSQP section 5.1): the mean Hessian column
        # norm or the gradient norm O(1)
        pcol = _amax(P, -2).mean(-1)
        qn = _amax(q, -1)
        g = _guard(1.0 / torch.maximum(pcol, qn))
        P = P * g[..., None, None]
        q = q * g.unsqueeze(-1)
        d, e, c = d * dd, e * de, c * g

    # classification invariance: the solver classifies rows from the data
    # (src/qp.cpp:284-294), so row scaling must not move a row across a
    # boundary: an inequality gap e (u - l) shrunk below RHO_TOL would be
    # solved as an equality, and a finite bound pushed past
    # LOOSE_BOUNDS_THRESH would make the row loose.  Any positive row scaling
    # is algebraically valid, so e is corrected per row.
    gap0 = problem.u - problem.l
    # gap crossings matter only for rows with both bounds finite
    ineq_finite = (gap0 >= RHO_TOL) & ~loose_l & ~loose_u
    eq0 = gap0 < RHO_TOL
    one = torch.ones((), dtype=dtype, device=dev)
    gap = torch.clamp_min(u - l, 1e-30)
    ce_up = torch.where(
        ineq_finite & ((u - l) < RHO_TOL), (1.01 * RHO_TOL) / gap,
        # equality rows scaled up cross the other way
        torch.where(eq0 & ((u - l) >= RHO_TOL), (0.5 * RHO_TOL) / gap, one))
    bound_mag = torch.maximum(torch.where(loose_l, zero, l).abs(),
                              torch.where(loose_u, zero, u).abs()) * ce_up
    ce_down = torch.where(bound_mag > 0.1 * LOOSE_BOUNDS_THRESH,
                          (0.1 * LOOSE_BOUNDS_THRESH) / torch.clamp_min(bound_mag, 1e-30), one)
    ce = ce_up * ce_down
    A = A * ce.unsqueeze(-1)
    l = l * ce
    u = u * ce
    e = e * ce

    # restore the loose sentinels (never active; keeps the classification
    # of loose rows)
    l = torch.where(loose_l, torch.full_like(l, -_BIG), l)
    u = torch.where(loose_u, torch.full_like(u, _BIG), u)
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u), Scaling(d=d, e=e, c=c)


def solve_with_scaling(inner_solve, qp: QuadraticProblem, settings: QPSettings,
                       state=None) -> QPResult:
    """The one scale -> solve -> unscale -> polish -> rescore pipeline of
    every entry point.  ``inner_solve(scaled_qp, inner_settings,
    scaled_state)`` runs whichever tier the caller dispatches to; polish
    runs after unscaling, in the original coordinates, where the
    active-set thresholds mean something."""
    scaled, s = ruiz_equilibrate(qp, settings.scaling)
    # check_comp_slack is stripped from the inner solve: in scaled space the
    # violation is below any threshold (unscaling amplifies it ~1e4x), and
    # stripping it lets the whole-solve kernel tiers, which refuse it, run
    # here.  The true check is rescore()'s, in original coordinates.
    inner = dataclasses.replace(settings, scaling=0, polish=False, check_comp_slack=False)
    st = None if state is None else scale_state(state, s)
    res = unscale_result(inner_solve(scaled, inner, st), s)
    if settings.polish:
        from sqp_solver_tpu_torch.qp.polish import polish_qp

        res = polish_qp(qp, res, settings)
    return rescore(qp, res, settings)


def scale_state(state: QPState, s: Scaling) -> QPState:
    """A warm start from original to scaled coordinates."""
    return QPState(x=state.x / s.d, z=state.z * s.e, y=state.y * s.c.unsqueeze(-1) / s.e)


def unscale_result(result: QPResult, s: Scaling) -> QPResult:
    """A scaled problem's result in original coordinates (``info`` still
    refers to the scaled problem: follow with :func:`rescore`)."""
    return QPResult(x=result.x * s.d, z=result.z / s.e,
                    y=result.y * s.e / s.c.unsqueeze(-1), info=result.info)


def rescore(problem: QuadraticProblem, result: QPResult, settings: QPSettings) -> QPResult:
    """True residuals of ``result`` on the original problem and the status
    re-derived against the original tolerances (reference termination
    math, src/qp.cpp:344-361, unscaled).  NUMERICAL_ISSUES and the
    infeasibility certificates pass through: a certificate of the scaled
    problem certifies the original (it transforms by the same diagonal
    scaling)."""
    from sqp_solver_tpu_torch.utils.precision import pin_precision

    return pin_precision(_rescore_impl)(problem, result, settings)


def _rescore_impl(problem, result, settings):
    P, q, A = problem.P, problem.q, problem.A
    x, z, y = result.x, result.z, result.y
    Ax = torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)
    Px = torch.matmul(P, x.unsqueeze(-1)).squeeze(-1)
    ATy = torch.matmul(y.unsqueeze(-2), A).squeeze(-2)

    def linf(v):
        return v.abs().amax(dim=-1)

    res_prim = linf(Ax - z)
    res_dual = linf(Px + q + ATy)
    eps_prim = settings.eps_abs + settings.eps_rel * torch.maximum(linf(Ax), linf(z))
    eps_dual = settings.eps_abs + settings.eps_rel * torch.maximum(
        torch.maximum(linf(Px), linf(ATy)), linf(q))
    solved = (res_prim <= eps_prim) & (res_dual <= eps_dual)
    if settings.check_comp_slack:
        # the true comp-slack violation, in original coordinates: on
        # degenerate families (huber) the scaled-space violation is below
        # threshold while unscaling amplifies it ~1e4x.  z is clipped to the
        # bounds on output, so "at bound" is a thin test
        l_, u_ = problem.l, problem.u
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        btol = 64.0 * torch.finfo(z.dtype).eps
        at_l = z <= l_ + btol * (1.0 + l_.abs())
        at_u = z >= u_ - btol * (1.0 + u_.abs())
        dsv = (torch.where(~at_u, torch.clamp_min(y, 0.0), zero)
               + torch.where(~at_l, torch.clamp_min(-y, 0.0), zero)).amax(dim=-1)
        solved = solved & (dsv <= settings.eps_abs + settings.eps_rel * linf(y))
    old = result.info.status
    passthrough = ((old == QPStatus.NUMERICAL_ISSUES) | (old == QPStatus.PRIMAL_INFEASIBLE)
                   | (old == QPStatus.DUAL_INFEASIBLE))
    status = torch.where(passthrough, old,
                         torch.where(solved, int(QPStatus.SOLVED),
                                     int(QPStatus.MAX_ITER_EXCEEDED))).to(torch.int32)
    info = QPInfo(status=status, iter=result.info.iter, rho_updates=result.info.rho_updates,
                  rho_estimate=result.info.rho_estimate, res_prim=res_prim, res_dual=res_dual)
    return QPResult(x=x, y=y, z=z, info=info)
