"""The check that decides ``correct``: each answer judged by what it says.

Plain PyTorch in float64, from the benchmark's own inputs (P, q, A, l, u)
and the answers (x, z, y, status, the reported residuals); it imports
nothing of the program.  An answer says three things, and each is checked:

* its status: every instance that the generator draws has a feasible point
  (the clipped LQR rollout) and a bounded feasible set, so a primal or dual
  infeasibility status, or a code the entry does not have, is wrong
  (``wrong_status``, a count, limit 0);
* its claims (``claim_excess``, the largest of the following two, each as
  a share of its bar; no claim in the run reads as no number, which fails):
  SOLVED: (x, z, y) meets the OSQP termination test at the configuration's
  bars (eps_abs, eps_rel), recomputed here in float64:
  r_p = |Ax - z|_inf + dist(z, [l, u]) <= eps_abs + eps_rel max(|Ax|, |z|),
  r_d = |Px + q + A'y|_inf <= eps_abs + eps_rel max(|Px|, |A'y|, |q|);
  the share by which r_p or r_d lies past its bar (0 inside);
  SOLVED or out of iterations: the r_p and r_d that the answer reports are
  those of its (x, z, y); the gap between the reported and the recomputed;
* how many it solved: ``unsolved_share``, the share of the answers judged
  that are not SOLVED (out of iterations, numerical issues or any other
  code), held to the cell's own limit, since an answer that honestly says
  it stopped short still leaves its problem unsolved.

A non-finite reading counts as infinite.  Status codes are the entry's
(OSQP's, with the infeasibility certificates): 0 solved, 1 out of
iterations, 3 numerical issues, 5 primal and 6 dual infeasible.
"""

from __future__ import annotations

import math

import torch

__all__ = ["SOLVED", "MAX_ITER", "answer_readings", "summarize"]

SOLVED, MAX_ITER, NUMERICAL, PRIMAL_INF, DUAL_INF = 0, 1, 3, 5, 6
KNOWN = (SOLVED, MAX_ITER, NUMERICAL, PRIMAL_INF, DUAL_INF)


def _linf(v):
    return v.abs().amax(-1)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def answer_readings(qp: dict, ans: dict, eps_abs: float, eps_rel: float) -> dict:
    """Per problem of one batch, in float64: ``ratio`` (the larger of
    r_p / bar_p and r_d / bar_d), ``gap`` (the larger reported-against-
    recomputed gap of the two, over its bar) and ``wrong`` (an infeasibility
    or unknown status on an instance with a feasible point).  ``qp`` holds
    P, q, A, l, u, feasible; ``ans`` x, z, y, status, res_prim, res_dual."""
    f = torch.float64
    P, q, A, l, u = (qp[k].to(f) for k in ("P", "q", "A", "l", "u"))
    n = q.shape[-1]
    x, z, y = ans["x"].to(f)[:, :n], ans["z"].to(f), ans["y"].to(f)
    Ax, Px, ATy = _mv(A, x), _mv(P, x), _mv(A.mT, y)
    out_of_box = _linf(torch.clamp_min(l - z, 0.0) + torch.clamp_min(z - u, 0.0))
    rp = _linf(Ax - z) + out_of_box
    rd = _linf(Px + q + ATy)
    bar_p = eps_abs + eps_rel * torch.maximum(_linf(Ax), _linf(z))
    bar_d = eps_abs + eps_rel * torch.maximum(torch.maximum(_linf(Px), _linf(ATy)), _linf(q))
    ratio = torch.maximum(rp / bar_p, rd / bar_d)
    gap = torch.maximum((rp - ans["res_prim"].to(f)).abs() / bar_p,
                        (rd - ans["res_dual"].to(f)).abs() / bar_d)
    status = ans["status"].long()
    unknown = torch.ones_like(status, dtype=torch.bool)
    for code in KNOWN:
        unknown &= status != code
    infeasible = (status == PRIMAL_INF) | (status == DUAL_INF)
    wrong = (infeasible & qp["feasible"]) | unknown
    return dict(ratio=torch.nan_to_num(ratio, nan=math.inf),
                gap=torch.nan_to_num(gap, nan=math.inf), wrong=wrong, status=status)


def summarize(readings: list) -> dict:
    """The compared numbers over every answer judged: ``claim_excess``
    (None where no answer claims SOLVED or out of iterations),
    ``unsolved_share`` and ``wrong_status``; and the counts."""
    ratio = torch.cat([r["ratio"] for r in readings])
    gap = torch.cat([r["gap"] for r in readings])
    status = torch.cat([r["status"] for r in readings])
    wrong = torch.cat([r["wrong"] for r in readings])
    solved = status == SOLVED
    told = solved | (status == MAX_ITER)
    claim = None
    if bool(told.any()):
        excess = torch.clamp_min(ratio - 1.0, 0.0).masked_fill(~solved, 0.0)
        claim = float(torch.maximum(excess, gap)[told].amax())
    judged, n_solved = int(status.numel()), int(solved.sum())
    return dict(wrong_status=int(wrong.sum()), claim_excess=claim,
                unsolved_share=(judged - n_solved) / judged, judged=judged, solved=n_solved)
