"""A plain OSQP ADMM in PyTorch: the reference solver put in the program's
place for the control, computed in a stated precision.

The iteration of OSQP (Stellato et al. 2020, algorithm 1) with the
configuration's settings: per row rho (1e3 rho on equality rows, u - l <
1e-4), the x-update by triangular solves with the Cholesky factor of
M = P + sigma I + A' diag(rho) A (never its explicit inverse, which loses
every digit at M's condition of about 1e9), over-relaxation alpha, termination
checked every ``check_termination`` iterations on the OSQP test, and every
``adaptive_rho_interval`` iterations rho re-estimated from the residuals'
ratio (kept within 1e-6..1e6, changed where it moves by more than the
tolerance, M refactored).  A problem stops at the check that it passes;
its (x, z, y) and the residuals it reports are that check's.

``precision``: ``"float64"``, ``"float32"``, or ``"tf32"``: float32 with
every matrix product's operands rounded to TF32 (10 mantissa bits) and
accumulated in float32, as the card's tensor cores compute a float32
product with TF32 on; the factor and its triangular solves, which the
card's libraries do not run on the tensor cores, stay float32 on M so
assembled.  The rounding is
done here, so the control reads the same on the CPU and the card.
"""

from __future__ import annotations

import torch

__all__ = ["admm_solve", "tf32_round"]

RHO_MIN, RHO_MAX, RHO_EQ, RHO_TOL = 1e-6, 1e6, 1e3, 1e-4


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _product(precision: str):
    if precision == "tf32":
        return lambda M, v: tf32_round(M) @ tf32_round(v)
    return lambda M, v: M @ v


def admm_solve(P, q, A, l, u, settings: dict, precision: str = "float64") -> dict:
    """Solve the batch (P (B, n, n), q (B, n), A (B, m, n), l, u (B, m)) from
    a cold start.  Returns x, z, y, status (0 solved, 1 out of iterations,
    3 where M had no Cholesky factor), iter, res_prim, res_dual, each as the
    answer reports it."""
    dt = torch.float64 if precision == "float64" else torch.float32
    mm = _product(precision)
    P, q, A, l, u = (t.to(dt) for t in (P, q, A, l, u))
    B, n = q.shape
    m = l.shape[-1]
    sigma, alpha = settings["sigma"], settings["alpha"]
    eps_abs, eps_rel = settings["eps_abs"], settings["eps_rel"]
    check, interval = settings["check_termination"], settings["adaptive_rho_interval"]
    adaptive, tol = settings["adaptive_rho"], settings["adaptive_rho_tolerance"]
    eq = (u - l) < RHO_TOL
    eye = torch.eye(n, dtype=dt, device=q.device)
    At = A.mT.contiguous()

    def mv(M, v):
        return mm(M, v.unsqueeze(-1)).squeeze(-1)

    def rho_rows(rho):
        return torch.where(eq, RHO_EQ * rho.unsqueeze(-1), rho.unsqueeze(-1))

    def factor(rv):
        """M's Cholesky factor, and where M has none in this precision, the
        problem marked failed."""
        M = P + sigma * eye + mm(At * rv.unsqueeze(-2), A)
        L, info = torch.linalg.cholesky_ex(M)
        bad = info != 0
        L = torch.where(bad.view(-1, 1, 1), eye, L)
        return L, bad

    def solve(L, v):
        return torch.cholesky_solve(v.unsqueeze(-1), L).squeeze(-1)

    def residuals(x, z, y):
        Ax, Px, ATy = mv(A, x), mv(P, x), mv(At, y)
        lin = lambda v: v.abs().amax(-1)  # noqa: E731
        rp, rd = lin(Ax - z), lin(Px + q + ATy)
        sp, sd = torch.maximum(lin(Ax), lin(z)), torch.maximum(torch.maximum(lin(Px), lin(ATy)),
                                                                lin(q))
        return rp, rd, sp, sd

    rho = torch.full((B,), float(settings["rho"]), dtype=dt, device=q.device)
    rv = rho_rows(rho)
    L, failed = factor(rv)
    x = torch.zeros((B, n), dtype=dt, device=q.device)
    z = torch.zeros((B, m), dtype=dt, device=q.device)
    y = torch.zeros((B, m), dtype=dt, device=q.device)
    done = torch.zeros(B, dtype=torch.bool, device=q.device)
    keep = dict(x=x, z=z, y=y, rp=torch.full_like(rho, float("inf")),
                rd=torch.full_like(rho, float("inf")),
                it=torch.zeros(B, dtype=torch.int32, device=q.device))
    for k in range(1, settings["max_iter"] + 1):
        rhs = sigma * x - q + mv(At, rv * z - y)
        xt = solve(L, rhs)
        zt = mv(A, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        z_pre = alpha * zt + (1.0 - alpha) * z
        z_new = torch.clamp(z_pre + y / rv, min=l, max=u)
        y = y + rv * (z_pre - z_new)
        x, z = x_new, z_new
        if k % check and k != settings["max_iter"]:
            continue
        rp, rd, sp, sd = residuals(x, z, y)
        live = ~done & ~failed
        conv = (rp <= eps_abs + eps_rel * sp) & (rd <= eps_abs + eps_rel * sd) & live
        for key, v in (("x", x), ("z", z), ("y", y)):
            keep[key] = torch.where(live.unsqueeze(-1), v, keep[key])
        keep["rp"] = torch.where(live, rp, keep["rp"])
        keep["rd"] = torch.where(live, rd, keep["rd"])
        keep["it"] = torch.where(live, k, keep["it"])
        done = done | conv
        if bool((done | failed).all()):
            break
        if adaptive and k % interval == 0 and k < settings["max_iter"]:
            new = torch.clamp(rho * torch.sqrt((rp / (sp + 1e-30)) / (rd / (sd + 1e-30) + 1e-30)),
                              RHO_MIN, RHO_MAX)
            change = ((new < rho / tol) | (new > rho * tol)) & ~done & ~failed
            if bool(change.any()):
                rho = torch.where(change, new, rho)
                rv = rho_rows(rho)
                L_new, bad = factor(rv)
                L = torch.where(change.view(-1, 1, 1), L_new, L)
                failed = failed | (change & bad)
    status = torch.where(done, 0, torch.where(failed, 3, 1)).to(torch.int32)
    return dict(x=keep["x"], z=keep["z"], y=keep["y"], status=status, iter=keep["it"],
                res_prim=keep["rp"], res_dual=keep["rd"])
