"""The differentiable QP layer ``qp_solve_diff`` against the JAX package's
(its ``tests/test_diff.py``), float64.

The gradients to P, q, A, l and u of a loss through the solver equal the
JAX package's (``jax.grad`` through its custom VJP) to 1e-8 relative, on
the vmap and the fused tier, and central finite differences of the
forward solve under the JAX tests' bars; inactive rows get exactly zero;
one problem without the batch axis splits an equality row's gradient
50/50 between l and u; the adjoint's K2 route and K4 route (their plain
versions here) agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.models.mpc import random_qp_batch as jax_random_qp_batch
from sqp_solver_tpu.qp import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp import QuadraticProblem as JaxQP
from sqp_solver_tpu.qp import qp_solve_diff as jax_qp_solve_diff
from sqp_solver_tpu_torch.models.mpc import random_qp_batch
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings, QuadraticProblem, qp_solve_diff
from sqp_solver_tpu_torch.qp.diff import qp_solve_vjp

LEAVES = ("P", "q", "A", "l", "u")
# tight forward solves, so that the finite differences are clean
TIGHT = dict(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000, adaptive_rho=True,
             adaptive_rho_interval=50, polish=True)


def _leaves(qp, requires_grad=True):
    return {k: torch.tensor(np.asarray(getattr(qp, k)), requires_grad=requires_grad)
            for k in LEAVES}


def _port_grads(leaves, gvec, settings, impl="vmap"):
    x = qp_solve_diff(QuadraticProblem(**leaves), settings, impl)
    (torch.as_tensor(gvec) * x).sum().backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}


def _jax_grads(jq, gvec, settings, impl="vmap"):
    g = jax.grad(lambda q_: jnp.sum(jnp.asarray(gvec) * jax_qp_solve_diff(q_, settings, impl)))(
        jq)
    return {k: np.asarray(getattr(g, k)) for k in LEAVES}


def _assert_grads_equal(got, want):
    for k in LEAVES:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8 * scale, err_msg=k)


@pytest.mark.parametrize("impl", ["vmap", "fused"])
def test_qp_grads_match_jax(impl):
    jq = jax_random_qp_batch(batch=3, n=6, m=9, seed=5, dtype=jnp.float64)
    gvec = np.random.default_rng(0).normal(size=(3, 6))
    kw = TIGHT if impl == "vmap" else dict(TIGHT, max_iter=4000, schedule="fixed")
    want = _jax_grads(jq, gvec, JaxQPSettings(**kw), impl)
    got = _port_grads(_leaves(jq), gvec, QPSettings(**kw), impl)
    _assert_grads_equal(got, want)
    assert all(np.abs(got[k]).max() > 0 for k in LEAVES)


def test_qp_grads_match_finite_differences():
    """JAX tests/test_diff.py:24-75: five random coordinates a leaf, P
    perturbed symmetrically, bar 1e-4 (1 + |fd|)."""
    pq = random_qp_batch(batch=3, n=6, m=9, seed=5, dtype=torch.float64, device="cpu")
    gvec = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 6)))
    settings = QPSettings(**TIGHT)
    leaves = {k: getattr(pq, k).clone().requires_grad_(True) for k in LEAVES}
    grads = _port_grads(leaves, gvec.numpy(), settings)

    def loss(**over):
        res = qp_solve_batch(dataclasses.replace(pq, **over), settings)
        return float((gvec * res.x).sum())

    eps = 1e-6
    rng = np.random.default_rng(1)
    for leaf in LEAVES:
        base = getattr(pq, leaf).numpy()
        for fi in rng.choice(base.size, size=5, replace=False):
            idx = np.unravel_index(fi, base.shape)
            pert = np.zeros_like(base)
            pert[idx] = eps
            if leaf == "P":
                pert = pert + np.swapaxes(pert, -1, -2)  # e_ij + e_ji
            fd = (loss(**{leaf: torch.as_tensor(base + pert)})
                  - loss(**{leaf: torch.as_tensor(base - pert)})) / (2 * eps)
            an = grads[leaf][idx]
            if leaf == "P":
                an = an + grads[leaf][idx[:-2] + (idx[-1], idx[-2])]
            assert abs(fd - an) < 1e-4 * (1.0 + abs(fd)), (leaf, idx, fd, an)


def test_inactive_bounds_zero_gradient():
    pq = random_qp_batch(batch=2, n=5, m=7, seed=9, dtype=torch.float64, device="cpu")
    l, u = pq.l.clone(), pq.u.clone()
    l[:, -1], u[:, -1] = -1e4, 1e4
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              zip(LEAVES, (pq.P, pq.q, pq.A, l, u))}
    grads = _port_grads(leaves, np.ones((2, 5)), QPSettings(**TIGHT))
    assert (grads["l"][:, -1] == 0).all() and (grads["u"][:, -1] == 0).all()
    assert (grads["A"][:, -1, :] == 0).all()


def test_single_problem_equality_split():
    """JAX tests/test_diff.py:92-110: one problem without the batch axis;
    the equality row's gradient splits 50/50; finite differences on q."""
    vals = dict(P=[[4.0, 1.0], [1.0, 2.0]], q=[1.0, 1.0], A=[[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]],
                l=[1.0, 0.0, 0.0], u=[1.0, 0.7, 0.7])
    jq = JaxQP(**{k: jnp.asarray(v, jnp.float64) for k, v in vals.items()})
    gvec = np.array([1.0, -2.0])
    want = _jax_grads(jq, gvec, JaxQPSettings(**TIGHT))
    got = _port_grads(_leaves(jq), gvec, QPSettings(**TIGHT))
    _assert_grads_equal(got, want)
    np.testing.assert_allclose(got["l"][0], got["u"][0], rtol=1e-12)
    assert got["l"][0] != 0.0
    eps = 1e-6
    base = {k: torch.tensor(v, dtype=torch.float64) for k, v in vals.items()}
    for i in range(2):
        def loss(sign):
            q = base["q"].clone()
            q[i] += sign * eps
            x = qp_solve_diff(QuadraticProblem(**dict(base, q=q)), QPSettings(**TIGHT))
            return float((torch.as_tensor(gvec) * x).sum())

        fd = (loss(1.0) - loss(-1.0)) / (2 * eps)
        assert abs(fd - got["q"][i]) < 1e-5, (i, fd, got["q"][i])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_and_plain_adjoint_routes_agree(dtype):
    """JAX tests/test_diff.py:198-230: the adjoint through K2 and through K4
    (here their plain versions) give the same gradients."""
    pq = random_qp_batch(batch=3, n=6, m=9, seed=11, dtype=dtype, device="cpu")
    eps = 1e-5 if dtype == torch.float32 else 1e-7  # what float32 can reach
    settings = QPSettings(eps_abs=eps, eps_rel=eps, max_iter=4000, adaptive_rho=True,
                          polish=True)
    res = qp_solve_batch(pq, settings)
    assert (res.info.status == 0).all()
    g = 2.0 * res.x
    routes = [qp_solve_vjp(pq.P, pq.A, pq.l, pq.u, res.x, res.y, res.info.status, g, settings,
                           use_kernel=k) for k in (True, False)]
    tol = 1e-5 if dtype == torch.float32 else 1e-9
    for a, b in zip(*routes):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol)
    assert routes[0][1].abs().max() > 0
