"""Structured batch SQP tier (twin of ``sqp_solver_tpu/sqp/solver_btd.py``):
the btd inner QP for stage-wise NLPs.

The outer algorithm is the kernel tier's (Algorithm 18.3: damped BFGS, l1
merit line search, optional SOC; reference ``src/sqp.cpp:44-101``), run
by the shared :func:`sqp_solver_tpu_torch.sqp.common.sqp_outer_loop`.  The
QP subproblem goes to the structured kernel
(:func:`sqp_solver_tpu_torch.ops.qp_kernel_btd.btd_step_kernel`, K7):
block-Thomas factor O(T bb^3) and band sweeps O(n bb) in place of the
dense kernel's O(n^3) Cholesky and O(n^2) matvecs.

The Hessian estimate is a **per-stage block-diagonal damped BFGS**: the
damped update (Procedure 18.2) applied to each ``bb``-sized diagonal
block with the block's slice of the step and of the Lagrangian-gradient
change, carried as a band (B, T, bb, bb).  For stage-separable NLPs the
true Lagrangian Hessian is block-diagonal in the stage blocks, so the
restriction keeps its structure.  It is a different quasi-Newton sequence
from the dense tiers.

No posdef repair: a failed block factor gives p = 0 and a failed line
search, so the next iteration resets that problem's band to I.  The SOC
re-solve carries the rho of the first solve's final factor (``rho_in``)
and refactors, which costs O(T bb^3).

Requirements (``ValueError``): ``settings.qp.block_size`` declared, n a
multiple of the internal block, and ``settings.qp.scaling == 0``.
"""

from __future__ import annotations

from typing import Optional

import torch

from sqp_solver_tpu_torch.ops.qp_kernel_btd import (
    COMPACT_ABOVE,
    btd_internal_block,
    btd_step_kernel,
    compact_nnz,
)
from sqp_solver_tpu_torch.qp.types import QPState
from sqp_solver_tpu_torch.sqp import common
from sqp_solver_tpu_torch.sqp.types import NonlinearProblem, SQPResult, SQPSettings
from sqp_solver_tpu_torch.utils.precision import pin_precision

__all__ = ["sqp_solve_kernel_btd", "bfgs_update_band", "band_hessian"]


def bfgs_update_band(Bd, s, yv, reset, upd):
    """Per-stage damped BFGS on the block-diagonal band ``Bd`` (B, T, bb, bb)
    with the step ``s`` and gradient change ``yv`` (B, n): each block runs
    Procedure 18.2 (reference bfgs.hpp:14-41) on its slices; a block whose
    damped curvature s'r is below machine epsilon, or a problem with
    ``upd`` False, keeps its block; ``reset`` sets the problem's band to I."""
    dtype = Bd.dtype
    B, T, bb, _ = Bd.shape
    eps_m = torch.finfo(dtype).eps
    tiny_pos = torch.finfo(dtype).tiny
    s3 = s.reshape(B, T, bb)
    y3 = yv.reshape(B, T, bb)
    Bs = torch.matmul(Bd, s3.unsqueeze(-1)).squeeze(-1)  # (B, T, bb)
    sBs = (s3 * Bs).sum(-1, keepdim=True)  # (B, T, 1)
    sy = (s3 * y3).sum(-1, keepdim=True)
    damped = sy < 0.2 * sBs
    theta = 0.8 * sBs / torch.clamp_min(sBs - sy, tiny_pos)
    r = torch.where(damped, theta * y3 + (1.0 - theta) * Bs, y3)
    sr = torch.where(damped, theta * sy + (1.0 - theta) * sBs, sy)
    Bupd = (
        Bd
        - (Bs.unsqueeze(-1) * Bs.unsqueeze(-2)) / torch.clamp_min(sBs, tiny_pos).unsqueeze(-1)
        + (r.unsqueeze(-1) * r.unsqueeze(-2)) / torch.clamp_min(sr, tiny_pos).unsqueeze(-1)
    )
    keep = (sr < eps_m) | ~upd[:, None, None]  # (B, T, 1)
    Bn = torch.where(keep.unsqueeze(-1), Bd, Bupd)
    eye = torch.eye(bb, dtype=dtype, device=Bd.device)
    return torch.where(reset[:, None, None, None], eye, Bn)


def band_hessian(bb: int) -> common.HessianForm:
    """The block-diagonal band as the outer loop's Hessian form: I at the
    first iteration, p'Bp from the blocks, and the dense (B, n, n)
    block-diagonal matrix for the polish epilogue's NaN fallback."""

    def init(B, n, dtype, device):
        eye = torch.eye(bb, dtype=dtype, device=device)
        return eye.expand(B, n // bb, bb, bb).contiguous()

    def pbp(Bd, p):
        B, T, _, _ = Bd.shape
        p3 = p.reshape(B, T, bb)
        return (p3 * torch.matmul(Bd, p3.unsqueeze(-1)).squeeze(-1)).sum((-2, -1))

    def dense(Bd):
        B, T, _, _ = Bd.shape
        eye_t = torch.eye(T, dtype=Bd.dtype, device=Bd.device)
        return torch.einsum("btij,ts->btisj", Bd, eye_t).reshape(B, T * bb, T * bb)

    return common.HessianForm(init=init, pbp=pbp, dense=dense)


@pin_precision
def sqp_solve_kernel_btd(
    problem: NonlinearProblem,
    x0: torch.Tensor,
    lam0: Optional[torch.Tensor] = None,
    settings: SQPSettings = SQPSettings(),
) -> SQPResult:
    """Solve a batch of stage-wise NLPs through the structured SQP tier;
    ``x0`` is (B, n).  Select with ``SQPSettings(qp_impl="kernel_btd",
    qp=QPSettings(block_size=b, ...))`` where every Schur matrix
    B + sigma I + J' rho J is block-tridiagonal at block size b."""
    settings.validate()
    if settings.qp.block_size <= 0:
        raise ValueError("qp_impl='kernel_btd' requires qp.block_size > 0")
    if settings.qp.scaling > 0:
        raise ValueError(
            "qp_impl='kernel_btd' does not support inner-QP scaling "
            "(band-layout Ruiz is not implemented); set qp.scaling=0"
        )
    batch, n = x0.shape
    bb = btd_internal_block(int(settings.qp.block_size))
    if n % bb:
        raise ValueError(
            f"qp_impl='kernel_btd': n={n} must be a multiple of the internal "
            f"block {bb} (declared block_size={settings.qp.block_size}); pad the "
            "stage blocks with decoupled variables at the model level"
        )
    soc = settings.second_order_correction
    # the Hessian estimate is block-diagonal: its sub-diagonal band is zero
    pe_zero = torch.zeros((batch, n // bb, bb, bb), dtype=x0.dtype, device=x0.device)

    def step(s: common.SubproblemInputs):
        pd = bfgs_update_band(s.B, s.step_prev, s.delta_grad_L, s.reset, s.upd)
        # past the wide kernel's band route the SOC re-solve takes the first
        # solve's count of J's nonzeros (one read back to the host a step)
        nnz = compact_nnz(s.J, bb) if soc and s.J.is_cuda and bb > COMPACT_ABOVE else None
        out = btd_step_kernel(pd, pe_zero, s.J, s.grad_obj, s.l - s.c_val, s.u - s.c_val,
                              s.active, s.warm.x, s.warm.z, s.warm.y, settings.qp, nnz=nnz)
        # a failed block factor froze the problem inside the kernel: its p is
        # the warm start, not a descent direction
        qp_fail = out.fail & s.active
        zero = torch.zeros_like(out.x)
        p = torch.where(qp_fail[:, None], zero, out.x)
        lam_qp, qp_it = out.y, out.iter
        state = QPState(x=p, z=out.z, y=lam_qp)
        if soc:
            d = s.c_of(s.x + p) - torch.matmul(s.J, p.unsqueeze(-1)).squeeze(-1)
            warm = state if settings.qp_warm_start else s.warm
            out2 = btd_step_kernel(pd, pe_zero, s.J, s.grad_obj, s.l - d, s.u - d,
                                   s.active & ~qp_fail, warm.x, warm.z, warm.y,
                                   settings.qp, rho_in=out.rho_factor, nnz=nnz)
            p = torch.where(qp_fail[:, None], zero, out2.x)
            lam_qp, qp_it = out2.y, qp_it + out2.iter
            state = QPState(x=p, z=out2.z, y=lam_qp)
        # inactive problems pass their band through: reset and upd are
        # masked by `active`
        return common.StepResult(p, lam_qp, pd, state, qp_it, ls_fail=qp_fail)

    return common.sqp_outer_loop(problem, x0, lam0, settings, step,
                                 hessian=band_hessian(bb))
