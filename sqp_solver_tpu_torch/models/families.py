"""OSQP-paper benchmark problem families as batched dense QPs (twin of
``sqp_solver_tpu/models/families.py``).

The reference library is an OSQP re-implementation, and the OSQP paper
(Stellato et al., arXiv:1711.08013, section 5) defines the problem classes
such a solver is expected to handle: random QPs, equality-constrained QPs,
portfolio optimization, lasso, huber fitting and support-vector machines.
Each generator gives a batch in the standard form

    min 0.5 z'Pz + q'z   s.t.   l <= Az <= u

with every field batch-first; equality rows are l == u.

The host generators draw with numpy from ``np.random.default_rng(seed)``
in the JAX package's order, so one seed gives the JAX package's problems
draw for draw, and return tensors on ``device`` (by default the card).
The ``*_device`` twins draw on the device from a ``torch.Generator``:
the same distributions and constructions, not the same draws as the JAX
package's ``jax.random`` twins.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from sqp_solver_tpu_torch.qp.types import QuadraticProblem
from sqp_solver_tpu_torch.utils.device import resolve_device

__all__ = [
    "equality_qp_batch",
    "lasso_qp_batch",
    "huber_qp_batch",
    "svm_qp_batch",
    "portfolio_qp_batch",
    "random_qp_batch_device",
    "lasso_qp_batch_device",
    "huber_qp_batch_device",
    "svm_qp_batch_device",
    "portfolio_qp_batch_device",
]

_INF = 1e20  # loose bound beyond the classifier's LOOSE_BOUNDS_THRESH (1e16)


def _as_problem(P, q, A, l, u, dtype, device) -> QuadraticProblem:
    dev = resolve_device(device)
    return QuadraticProblem(*(torch.as_tensor(np.asarray(v), dtype=dtype).to(dev)
                              for v in (P, q, A, l, u)))


def equality_qp_batch(
    batch: int, n: int = 16, p: int = 8, seed: int = 0, dtype=torch.float32, device=None
) -> Tuple[QuadraticProblem, np.ndarray]:
    """Equality-constrained QP: min ½xᵀPx + qᵀx s.t. Ax = b (OSQP §5.2).

    P = MMᵀ + 1e-2·I strictly convex, A Gaussian with full row rank,
    b = A x_feas.  Returns (problem, x_star) where x_star is the exact
    KKT solution [[P, Aᵀ],[A, 0]] [x; ν] = [−q; b], computed in float64 —
    a closed-form accuracy oracle for the whole solver stack.
    """
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(batch, n, n)) / np.sqrt(n)
    P = M @ M.transpose(0, 2, 1) + 1e-2 * np.eye(n)
    q = rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, p, n)) / np.sqrt(n)
    b = np.einsum("bpn,bn->bp", A, rng.normal(size=(batch, n)))

    K = np.zeros((batch, n + p, n + p))
    K[:, :n, :n] = P
    K[:, :n, n:] = A.transpose(0, 2, 1)
    K[:, n:, :n] = A
    rhs = np.concatenate([-q, b], axis=1)
    x_star = np.linalg.solve(K, rhs[..., None])[:, :n, 0]

    problem = _as_problem(P, q, A, b, b, dtype, device)
    return problem, x_star


def lasso_qp_batch(
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    seed: int = 0,
    lam_frac: float = 0.1,
    dtype=torch.float32,
    device=None,
) -> Tuple[QuadraticProblem, dict]:
    """Lasso regression as a QP (OSQP §5.3):  min ½‖Fx − b‖² + λ‖x‖₁.

    Lifted variable z = (x, y, t) with the residual y = Fx − b kept
    explicit (the paper's conditioning trick) and t the l1 envelope:

        min ½yᵀy + λ1ᵀt
        s.t. Fx − y = b          (n_samples equality rows)
             −t ≤ x ≤ t          (2·n_features inequality rows)

    λ = lam_frac · ‖Fᵀb‖∞ (a fraction of the smallest λ that zeroes x).
    Returns (problem, meta) with meta = dict(F, b, lam, n_features,
    n_samples) for objective evaluation in tests.
    """
    rng = np.random.default_rng(seed)
    nf, ns = n_features, n_samples
    F = rng.normal(size=(batch, ns, nf)) / np.sqrt(nf)
    x_true = rng.normal(size=(batch, nf)) * (rng.random(size=(batch, nf)) < 0.5)
    b = np.einsum("bsn,bn->bs", F, x_true) + 0.1 * rng.normal(size=(batch, ns))
    lam = lam_frac * np.max(
        np.abs(np.einsum("bsn,bs->bn", F, b)), axis=1, keepdims=True
    )  # (B, 1)

    nz = nf + ns + nf
    P = np.zeros((batch, nz, nz))
    P[:, nf : nf + ns, nf : nf + ns] = np.eye(ns)
    q = np.zeros((batch, nz))
    q[:, nf + ns :] = lam

    m = ns + 2 * nf
    A = np.zeros((batch, m, nz))
    A[:, :ns, :nf] = F
    A[:, :ns, nf : nf + ns] = -np.eye(ns)
    # x − t ≤ 0
    A[:, ns : ns + nf, :nf] = np.eye(nf)
    A[:, ns : ns + nf, nf + ns :] = -np.eye(nf)
    # x + t ≥ 0
    A[:, ns + nf :, :nf] = np.eye(nf)
    A[:, ns + nf :, nf + ns :] = np.eye(nf)

    l = np.concatenate(
        [b, np.full((batch, nf), -_INF), np.zeros((batch, nf))], axis=1
    )
    u = np.concatenate(
        [b, np.zeros((batch, nf)), np.full((batch, nf), _INF)], axis=1
    )
    meta = dict(F=F, b=b, lam=lam[:, 0], n_features=nf, n_samples=ns)
    return _as_problem(P, q, A, l, u, dtype, device), meta


def huber_qp_batch(
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    seed: int = 0,
    M: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[QuadraticProblem, dict]:
    """Huber fitting as a QP (OSQP §5.4):  min Σᵢ φ_M(fᵢᵀx − bᵢ) with
    φ_M(w) = w² for |w| ≤ M, M(2|w| − M) otherwise.

    Splitting z = (x, u, r, s): the residual w = u + r − s with the
    quadratic part u and the linear excess r, s ≥ 0:

        min uᵀu + 2M·1ᵀ(r + s)
        s.t. Fx − u − r + s = b;  r ≥ 0;  s ≥ 0.

    Data includes outliers so the linear branch is active.  Returns
    (problem, meta) with meta = dict(F, b, M, n_features, n_samples).
    """
    rng = np.random.default_rng(seed)
    nf, ns = n_features, n_samples
    F = rng.normal(size=(batch, ns, nf)) / np.sqrt(nf)
    x_true = rng.normal(size=(batch, nf))
    noise = 0.1 * rng.normal(size=(batch, ns))
    outlier = (rng.random(size=(batch, ns)) < 0.2) * rng.normal(
        size=(batch, ns)
    ) * 5.0
    b = np.einsum("bsn,bn->bs", F, x_true) + noise + outlier

    nz = nf + 3 * ns
    P = np.zeros((batch, nz, nz))
    P[:, nf : nf + ns, nf : nf + ns] = 2.0 * np.eye(ns)
    q = np.zeros((batch, nz))
    q[:, nf + ns :] = 2.0 * M

    m = 3 * ns
    A = np.zeros((batch, m, nz))
    A[:, :ns, :nf] = F
    A[:, :ns, nf : nf + ns] = -np.eye(ns)
    A[:, :ns, nf + ns : nf + 2 * ns] = -np.eye(ns)
    A[:, :ns, nf + 2 * ns :] = np.eye(ns)
    A[:, ns : 2 * ns, nf + ns : nf + 2 * ns] = np.eye(ns)
    A[:, 2 * ns :, nf + 2 * ns :] = np.eye(ns)

    l = np.concatenate([b, np.zeros((batch, 2 * ns))], axis=1)
    u = np.concatenate([b, np.full((batch, 2 * ns), _INF)], axis=1)
    meta = dict(F=F, b=b, M=M, n_features=nf, n_samples=ns)
    return _as_problem(P, q, A, l, u, dtype, device), meta


def svm_qp_batch(
    batch: int,
    n_features: int = 8,
    n_samples: int = 16,
    seed: int = 0,
    lam: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[QuadraticProblem, dict]:
    """Support-vector machine as a QP (OSQP §5.5):

        min ½‖x‖² + λ·1ᵀt
        s.t. t ≥ 1 − diag(b)Fx   (hinge),   t ≥ 0

    encoded as [diag(b)F, I] z ∈ [1, ∞) and [0, I] z ∈ [0, ∞) over
    z = (x, t).  Labels b ∈ {−1, +1} from a planted separator with flip
    noise so both hinge branches are exercised.  Returns (problem, meta)
    with meta = dict(F, b, lam).
    """
    rng = np.random.default_rng(seed)
    nf, ns = n_features, n_samples
    F = rng.normal(size=(batch, ns, nf))
    w_true = rng.normal(size=(batch, nf))
    margin = np.einsum("bsn,bn->bs", F, w_true)
    flip = np.where(rng.random(size=(batch, ns)) < 0.1, -1.0, 1.0)
    b_lab = np.sign(margin + 1e-12) * flip

    nz = nf + ns
    P = np.zeros((batch, nz, nz))
    P[:, :nf, :nf] = np.eye(nf)
    q = np.zeros((batch, nz))
    q[:, nf:] = lam

    m = 2 * ns
    A = np.zeros((batch, m, nz))
    A[:, :ns, :nf] = b_lab[:, :, None] * F
    A[:, :ns, nf:] = np.eye(ns)
    A[:, ns:, nf:] = np.eye(ns)
    l = np.concatenate([np.ones((batch, ns)), np.zeros((batch, ns))], axis=1)
    u = np.full((batch, m), _INF)
    meta = dict(F=F, b=b_lab, lam=lam)
    return _as_problem(P, q, A, l, u, dtype, device), meta


def portfolio_qp_batch(
    batch: int,
    n_assets: int = 16,
    n_factors: int = 4,
    seed: int = 0,
    gamma: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[QuadraticProblem, dict]:
    """Markowitz portfolio with a factor risk model (OSQP §5.6):

        max μᵀx − γ xᵀΣx,  Σ = FFᵀ + D,  1ᵀx = 1,  0 ≤ x ≤ 1.

    Lifted z = (x, y) with y = Fᵀx so the quadratic stays diagonal:

        min γ(xᵀDx + yᵀy) − μᵀx
        s.t. Fᵀx − y = 0;  1ᵀx = 1;  0 ≤ x ≤ 1.

    Returns (problem, meta) with meta = dict(mu, F, D, gamma).
    """
    rng = np.random.default_rng(seed)
    na, nk = n_assets, n_factors
    F = rng.normal(size=(batch, na, nk)) / np.sqrt(nk)
    D = rng.random(size=(batch, na)) * np.sqrt(nk) * 0.1 + 1e-2
    mu = rng.normal(size=(batch, na)) * 0.1

    nz = na + nk
    P = np.zeros((batch, nz, nz))
    idx = np.arange(na)
    P[:, idx, idx] = 2.0 * gamma * D
    kdx = np.arange(na, nz)
    P[:, kdx, kdx] = 2.0 * gamma
    q = np.concatenate([-mu, np.zeros((batch, nk))], axis=1)

    m = nk + 1 + na
    A = np.zeros((batch, m, nz))
    A[:, :nk, :na] = F.transpose(0, 2, 1)
    A[:, :nk, na:] = -np.eye(nk)
    A[:, nk, :na] = 1.0
    A[:, nk + 1 :, :na] = np.eye(na)
    l = np.concatenate(
        [np.zeros((batch, nk)), np.ones((batch, 1)), np.zeros((batch, na))],
        axis=1,
    )
    u = np.concatenate(
        [np.zeros((batch, nk)), np.ones((batch, 1)), np.ones((batch, na))],
        axis=1,
    )
    meta = dict(mu=mu, F=F, D=D, gamma=gamma)
    return _as_problem(P, q, A, l, u, dtype, device), meta


# ---------------------------------------------------------------------------
# Device-side generators: the same distributions drawn on the device from
# a torch.Generator, so a timing harness makes a fresh batch per run
# without a host upload.  Each returns only the QuadraticProblem.
# ---------------------------------------------------------------------------


def _generator(gen: Union[torch.Generator, int], device) -> torch.Generator:
    """``gen`` itself, or a generator on ``device`` (by default the card)
    seeded with the integer ``gen``."""
    if isinstance(gen, torch.Generator):
        return gen
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(gen))
    return g


def _draws(gen, dtype):
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)

    return normal, uniform


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def random_qp_batch_device(gen, batch: int, n: int = 32, m: int = 48,
                           dtype=torch.float32, device=None) -> QuadraticProblem:
    """Device-side twin of :func:`sqp_solver_tpu_torch.models.mpc.random_qp_batch`:
    random strictly convex QPs with feasible bounds.  ``gen`` is a
    ``torch.Generator`` (its device is the problems') or an integer seed
    for one on ``device``."""
    normal, uniform = _draws(_generator(gen, device), dtype)
    M = normal(batch, n, n) / math.sqrt(n)
    P = torch.matmul(M, M.mT) + 0.1 * _eye(n, M)
    q = normal(batch, n)
    A = normal(batch, m, n) / math.sqrt(n)
    x_feas = normal(batch, n)
    Ax = torch.matmul(A, x_feas.unsqueeze(-1)).squeeze(-1)
    width = 0.1 + 1.9 * uniform(batch, m)
    return QuadraticProblem(P=P, q=q, A=A, l=Ax - width, u=Ax + width)


def lasso_qp_batch_device(gen, batch: int, n_features: int = 8, n_samples: int = 16,
                          lam_frac: float = 0.1, dtype=torch.float32,
                          device=None) -> QuadraticProblem:
    """Device-side twin of :func:`lasso_qp_batch` (same lifting and scales)."""
    normal, uniform = _draws(_generator(gen, device), dtype)
    nf, ns = n_features, n_samples
    F = normal(batch, ns, nf) / math.sqrt(nf)
    x_true = normal(batch, nf) * (uniform(batch, nf) < 0.5)
    b = torch.matmul(F, x_true.unsqueeze(-1)).squeeze(-1) + 0.1 * normal(batch, ns)
    lam = lam_frac * torch.matmul(b.unsqueeze(-2), F).squeeze(-2).abs().amax(-1, keepdim=True)

    nz = nf + ns + nf
    P = F.new_zeros((batch, nz, nz))
    P[:, nf:nf + ns, nf:nf + ns] = _eye(ns, F)
    q = torch.cat([F.new_zeros((batch, nf + ns)), lam.expand(batch, nf)], dim=1)

    m = ns + 2 * nf
    A = F.new_zeros((batch, m, nz))
    A[:, :ns, :nf] = F
    A[:, :ns, nf:nf + ns] = -_eye(ns, F)
    A[:, ns:ns + nf, :nf] = _eye(nf, F)  # x - t <= 0
    A[:, ns:ns + nf, nf + ns:] = -_eye(nf, F)
    A[:, ns + nf:, :nf] = _eye(nf, F)  # x + t >= 0
    A[:, ns + nf:, nf + ns:] = _eye(nf, F)
    inf = F.new_full((batch, nf), _INF)
    zero = F.new_zeros((batch, nf))
    return QuadraticProblem(P=P, q=q, A=A, l=torch.cat([b, -inf, zero], dim=1),
                            u=torch.cat([b, zero, inf], dim=1))


def huber_qp_batch_device(gen, batch: int, n_features: int = 8, n_samples: int = 16,
                          M: float = 1.0, dtype=torch.float32,
                          device=None) -> QuadraticProblem:
    """Device-side twin of :func:`huber_qp_batch` (outliers included)."""
    normal, uniform = _draws(_generator(gen, device), dtype)
    nf, ns = n_features, n_samples
    F = normal(batch, ns, nf) / math.sqrt(nf)
    x_true = normal(batch, nf)
    noise = 0.1 * normal(batch, ns)
    outlier = (uniform(batch, ns) < 0.2) * normal(batch, ns) * 5.0
    b = torch.matmul(F, x_true.unsqueeze(-1)).squeeze(-1) + noise + outlier

    nz = nf + 3 * ns
    P = F.new_zeros((batch, nz, nz))
    P[:, nf:nf + ns, nf:nf + ns] = 2.0 * _eye(ns, F)
    q = torch.cat([F.new_zeros((batch, nf + ns)), F.new_full((batch, 2 * ns), 2.0 * M)], dim=1)

    m = 3 * ns
    A = F.new_zeros((batch, m, nz))
    A[:, :ns, :nf] = F
    A[:, :ns, nf:nf + ns] = -_eye(ns, F)
    A[:, :ns, nf + ns:nf + 2 * ns] = -_eye(ns, F)
    A[:, :ns, nf + 2 * ns:] = _eye(ns, F)
    A[:, ns:2 * ns, nf + ns:nf + 2 * ns] = _eye(ns, F)
    A[:, 2 * ns:, nf + 2 * ns:] = _eye(ns, F)
    return QuadraticProblem(
        P=P, q=q, A=A, l=torch.cat([b, F.new_zeros((batch, 2 * ns))], dim=1),
        u=torch.cat([b, F.new_full((batch, 2 * ns), _INF)], dim=1))


def svm_qp_batch_device(gen, batch: int, n_features: int = 8, n_samples: int = 16,
                        lam: float = 1.0, dtype=torch.float32,
                        device=None) -> QuadraticProblem:
    """Device-side twin of :func:`svm_qp_batch` (flip-noise labels)."""
    normal, uniform = _draws(_generator(gen, device), dtype)
    nf, ns = n_features, n_samples
    F = normal(batch, ns, nf)
    w_true = normal(batch, nf)
    margin = torch.matmul(F, w_true.unsqueeze(-1)).squeeze(-1)
    flip = torch.where(uniform(batch, ns) < 0.1, -1.0, 1.0).to(dtype)
    b_lab = torch.where(margin >= 0, 1.0, -1.0).to(dtype) * flip

    nz = nf + ns
    P = F.new_zeros((batch, nz, nz))
    P[:, :nf, :nf] = _eye(nf, F)
    q = torch.cat([F.new_zeros((batch, nf)), F.new_full((batch, ns), lam)], dim=1)

    m = 2 * ns
    A = F.new_zeros((batch, m, nz))
    A[:, :ns, :nf] = b_lab.unsqueeze(-1) * F
    A[:, :ns, nf:] = _eye(ns, F)
    A[:, ns:, nf:] = _eye(ns, F)
    return QuadraticProblem(
        P=P, q=q, A=A,
        l=torch.cat([F.new_ones((batch, ns)), F.new_zeros((batch, ns))], dim=1),
        u=F.new_full((batch, m), _INF))


def portfolio_qp_batch_device(gen, batch: int, n_assets: int = 16, n_factors: int = 4,
                              gamma: float = 1.0, dtype=torch.float32,
                              device=None) -> QuadraticProblem:
    """Device-side twin of :func:`portfolio_qp_batch` (factor risk model)."""
    normal, uniform = _draws(_generator(gen, device), dtype)
    na, nk = n_assets, n_factors
    F = normal(batch, na, nk) / math.sqrt(nk)
    D = uniform(batch, na) * math.sqrt(nk) * 0.1 + 1e-2
    mu = normal(batch, na) * 0.1

    nz = na + nk
    P = F.new_zeros((batch, nz, nz))
    idx = torch.arange(na, device=F.device)
    P[:, idx, idx] = 2.0 * gamma * D
    kdx = torch.arange(na, nz, device=F.device)
    P[:, kdx, kdx] = 2.0 * gamma
    q = torch.cat([-mu, F.new_zeros((batch, nk))], dim=1)

    m = nk + 1 + na
    A = F.new_zeros((batch, m, nz))
    A[:, :nk, :na] = F.mT
    A[:, :nk, na:] = -_eye(nk, F)
    A[:, nk, :na] = 1.0
    A[:, nk + 1:, :na] = _eye(na, F)
    l = torch.cat([F.new_zeros((batch, nk)), F.new_ones((batch, 1)), F.new_zeros((batch, na))],
                  dim=1)
    u = torch.cat([F.new_zeros((batch, nk)), F.new_ones((batch, 1)), F.new_ones((batch, na))],
                  dim=1)
    return QuadraticProblem(P=P, q=q, A=A, l=l, u=u)
