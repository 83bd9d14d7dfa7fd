"""The differentiable NLP layer ``sqp_solve_diff`` against the JAX
package's (its ``tests/test_diff.py::TestSQPDiff``), float64.

On TestSQPDiff's problem (a linear objective with parameters theta over a
ball and a box) the gradients to l, u and params equal the JAX package's
to 1e-8 relative and central finite differences of the forward solve
under the JAX test's bar; x0 and lam0 get zero gradients; shared bounds
get the batch's summed gradient; a problem without the raw callables
raises ``ValueError``.  Both packages run the same reduced budget (8
outers, inner QPs to 1e-6; the polish makes the solutions exact) on the
vmap tier.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.qp import QPSettings as JaxQPSettings
from sqp_solver_tpu.sqp import SQPSettings as JaxSQPSettings
from sqp_solver_tpu.sqp import sqp_solve_diff as jax_sqp_solve_diff
from sqp_solver_tpu.sqp.types import NonlinearProblem as JaxNLP
from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings
from sqp_solver_tpu_torch.sqp import NonlinearProblem, SQPSettings, SQPStatus, sqp_solve_diff

B, N = 3, 4
QP = dict(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=2000, check_termination=25,
          warm_start=True, adaptive_rho=True)
SQP = dict(max_iter=8, eps_prim=1e-9, eps_dual=1e-9, termination="kkt", polish=True,
           polish_passes=2)
SETTINGS = SQPSettings(qp=QPSettings(**QP), **SQP)


def _data():
    theta = np.asarray(1.0 + 0.2 * jax.random.normal(jax.random.PRNGKey(2), (B, N),
                                                     jnp.float64))
    r = np.array([1.2, 1.5, 0.9])
    l = np.zeros((B, N + 1))
    u = np.concatenate([(r ** 2)[:, None], np.full((B, N), 2.0)], axis=1)
    return dict(l=l, u=u, params=theta), np.full((B, N), 0.3)


def _port_problem(l, u, params):
    return NonlinearProblem(
        l=l, u=u, params=params, objective=lambda x, th: -(th * x).sum(-1),
        constraint=lambda x, th: torch.cat([(x * x).sum(-1, keepdim=True), x], dim=-1))


def test_sqp_grads_match_jax_and_finite_differences():
    data, x0 = _data()
    gvec = np.random.default_rng(7).normal(size=(B, N))
    jp = JaxNLP(**{k: jnp.asarray(v) for k, v in data.items()},
                objective=lambda x, th: -jnp.sum(th * x),
                constraint=lambda x, th: jnp.concatenate([jnp.array([x @ x]), x]))
    js = JaxSQPSettings(qp=JaxQPSettings(**QP), **SQP)
    want = jax.grad(lambda p: jnp.sum(jnp.asarray(gvec) * jax_sqp_solve_diff(
        p, jnp.asarray(x0), None, js, "vmap")))(jp)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in data.items()}
    x = sqp_solve_diff(_port_problem(**leaves), torch.as_tensor(x0), None, SETTINGS, "vmap")
    (torch.as_tensor(gvec) * x).sum().backward()
    for k in ("l", "u", "params"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(leaves[k].grad.numpy(), w, rtol=1e-8,
                                   atol=1e-8 * max(np.abs(w).max(), 1.0), err_msg=k)
    assert np.abs(leaves["params"].grad.numpy()).max() > 0

    def loss(**over):
        vals = {k: torch.tensor(v) for k, v in dict(data, **over).items()}
        res = sqp_solve_batch(_port_problem(**vals), torch.as_tensor(x0), None, SETTINGS)
        assert (res.info.status == SQPStatus.SOLVED).all()
        return float((torch.as_tensor(gvec) * res.x).sum())

    eps = 1e-6
    rng = np.random.default_rng(3)
    for leaf in ("params", "u"):
        base = data[leaf]
        for fi in rng.choice(base.size, size=3, replace=False):
            idx = np.unravel_index(fi, base.shape)
            pert = np.zeros_like(base)
            pert[idx] = eps
            fd = (loss(**{leaf: base + pert}) - loss(**{leaf: base - pert})) / (2 * eps)
            an = float(leaves[leaf].grad.numpy()[idx])
            assert abs(fd - an) < 1e-4 * (1.0 + abs(fd)), (leaf, idx, fd, an)


def test_start_zero_gradient_shared_bounds_single_problem():
    data, x0 = _data()
    xx = torch.tensor(x0, requires_grad=True)
    lam0 = torch.zeros((B, N + 1), dtype=torch.float64, requires_grad=True)
    problem = _port_problem(**{k: torch.tensor(v) for k, v in data.items()})
    sqp_solve_diff(problem, xx, lam0, SETTINGS, "vmap").sum().backward()
    assert (xx.grad == 0).all() and (lam0.grad == 0).all()
    # bounds shared by the batch get the sum of the problems' gradients:
    # two copies of problem 0 against it alone, one problem without the
    # batch axis (its params with the leading 1)
    th = torch.tensor(data["params"][:1])
    grads = []
    for xs, params in ((torch.as_tensor(x0[:2]), th.expand(2, N)), (torch.as_tensor(x0[0]), th)):
        u = torch.tensor(data["u"][0], requires_grad=True)
        p = _port_problem(torch.as_tensor(data["l"][0]), u, params)
        sqp_solve_diff(p, xs, None, SETTINGS, "vmap").sum().backward()
        grads.append(u.grad)
    assert grads[0].shape == (N + 1,) and grads[0].abs().max() > 0
    np.testing.assert_allclose(grads[0].numpy(), 2.0 * grads[1].numpy(), rtol=1e-8)
    with pytest.raises(ValueError, match="objective"):
        sqp_solve_diff(dataclasses.replace(problem, objective=None), xx, None, SETTINGS)
