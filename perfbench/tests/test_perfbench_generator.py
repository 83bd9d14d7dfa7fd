"""The generator's copy of the OSQP Control class draws feasible instances
of the class, from the seed alone."""

import pytest
import torch

from perfbench.generator import control_params, make_pool, problem_shape

CFGS = [dict(problem_class="control", nx=12, nu=6, horizon=10),
        dict(problem_class="control", nx=5, nu=3, horizon=6)]


def rollout_point(cfg, p, i):
    """The clipped LQR rollout of problem ``i`` as the stage-wise z."""
    Ad, Bd, QT, R = p["Ad"][i], p["Bd"][i], p["QT"][i], p["R"][i]
    K = torch.linalg.solve(R + Bd.T @ QT @ Bd, Bd.T @ QT @ Ad)
    x, z = p["x0"][i], []
    for _ in range(cfg["horizon"]):
        u = torch.clamp(-K @ x, -p["ubar"][i], p["ubar"][i])
        x = Ad @ x + Bd @ u
        z += [u, x]
    return torch.cat(z)


@pytest.mark.parametrize("cfg", CFGS, ids=["nx12", "nx5"])
def test_instances_are_feasible(cfg):
    """Every drawn instance holds the clipped LQR rollout as a point that
    meets its dynamics, its boxes and so l <= A z <= u."""
    pool = make_pool(cfg, dict(batch=6, pool_batches=2, set_seed=11), 2**31 + 5, "cpu")
    gen = torch.Generator().manual_seed(11)
    p = control_params(cfg, 12, gen, "cpu")
    order = torch.randperm(2, generator=gen.manual_seed(2**31 + 5)).tolist()
    n, m = problem_shape(cfg)
    for j, qp in zip(order, pool):
        assert qp["P"].shape == (6, n, n) and qp["A"].shape == (6, m, n)
        assert bool(qp["feasible"].all())
        for i in range(6):
            z = rollout_point(cfg, p, 6 * j + i)
            Az = qp["A"][i].double() @ z
            slack = 1e-5 * (1 + Az.abs())
            assert bool((Az >= qp["l"][i].double() - slack).all())
            assert bool((Az <= qp["u"][i].double() + slack).all())


@pytest.mark.parametrize("cfg", CFGS, ids=["nx12", "nx5"])
def test_class_structure(cfg):
    """The class's shapes: q = 0, P symmetric with R = 0.1 I on the inputs,
    nx T equality rows (the dynamics), positive box widths, and |A - I| of
    the plant's draw about 0.1 a entry."""
    nx, nu, T = cfg["nx"], cfg["nu"], cfg["horizon"]
    qp = make_pool(cfg, dict(batch=8, pool_batches=1, set_seed=3), 3, "cpu")[0]
    assert float(qp["q"].abs().max()) == 0.0
    assert torch.equal(qp["P"], qp["P"].mT)
    assert torch.allclose(qp["P"][:, 0, 0], torch.full((8,), 0.1))
    eq = (qp["u"] - qp["l"]).abs() < 1e-4
    assert int(eq.sum()) == 8 * nx * T
    assert bool((qp["u"][~eq] > qp["l"][~eq]).all())
    p = control_params(cfg, 64, torch.Generator().manual_seed(3), "cpu")
    delta = p["Ad"] - torch.eye(nx, dtype=torch.float64)
    assert 0.08 < float(delta.std()) < 0.12
    assert bool(((p["ubar"] >= 0) & (p["ubar"] <= 0.1)).all())
    assert bool(((p["xbar"] >= 1) & (p["xbar"] <= 2)).all())


def test_seed_orders_one_set_of_batches():
    """The same seed gives the same pool; another seed the same batches in
    another order."""
    cfg = CFGS[1]
    mix = dict(batch=4, pool_batches=6, set_seed=2**31 + 8)
    a, b = make_pool(cfg, mix, 2**31 + 9, "cpu"), make_pool(cfg, mix, 2**31 + 9, "cpu")
    c = make_pool(cfg, mix, 2**31 + 10, "cpu")
    for x, y in zip(a, b):
        for k in ("P", "A", "l", "u"):
            assert torch.equal(x[k], y[k])
    assert not all(torch.equal(x["A"], w["A"]) for x, w in zip(a, c))

    def key(qp):
        return tuple(qp["l"].flatten().tolist())

    assert sorted(map(key, a)) == sorted(map(key, c))
