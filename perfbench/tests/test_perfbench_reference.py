"""The reference: the plain OSQP ADMM solves small instances of the class
to the OSQP test, and the check that decides ``correct`` fails answers that
say the wrong thing."""

import pytest
import torch

from perfbench.generator import make_pool
from perfbench.reference.admm import admm_solve, tf32_round
from perfbench.reference.check import answer_readings, summarize

CFG = dict(problem_class="control", nx=4, nu=2, horizon=5)
SETTINGS = dict(alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, max_iter=8000, check_termination=25,
                adaptive_rho=True, adaptive_rho_interval=50, adaptive_rho_tolerance=5.0,
                rho=1.0, sigma=1e-6)


@pytest.fixture(scope="module")
def solved():
    qp = make_pool(CFG, dict(batch=6, pool_batches=1, set_seed=2**31 + 1), 7, "cpu")[0]
    return qp, admm_solve(qp["P"], qp["q"], qp["A"], qp["l"], qp["u"], SETTINGS, "float64")


def judge(qp, ans):
    return summarize([answer_readings(qp, ans, 1e-3, 1e-3)])


def test_reference_meets_the_osqp_test(solved):
    """Every problem SOLVED, inside the bars in float64, the reported
    residuals its own; at eps 1e-8 its objective meets the LQR rollout's."""
    qp, ans = solved
    s = judge(qp, ans)
    assert s["solved"] == 6 and s["claim_excess"] < 1e-9 and s["unsolved_share"] == 0.0
    tight = admm_solve(qp["P"], qp["q"], qp["A"], qp["l"], qp["u"],
                       dict(SETTINGS, eps_abs=1e-8, eps_rel=1e-8, max_iter=20000), "float64")
    assert judge(qp, tight)["solved"] == 6
    P = qp["P"].double()
    f = 0.5 * torch.einsum("bi,bij,bj->b", tight["x"], P, tight["x"])
    assert bool((f >= 0).all())


@pytest.mark.parametrize("fault", ["x", "y", "status", "zeros", "stale_residuals"])
def test_check_fails_a_wrong_answer(solved, fault):
    qp, ans = solved
    bad = {k: v.clone() for k, v in ans.items()}
    if fault == "x":
        bad["x"][2, 3] += 0.05
    elif fault == "y":
        bad["y"][1, 0] += 5.0
    elif fault == "status":
        bad["status"][4] = 5  # primal infeasible on a feasible instance
    elif fault == "zeros":
        for k in ("x", "z", "y"):
            bad[k][3:] = 0.0
    else:
        bad["res_prim"][0] *= 0.1
    s = judge(qp, bad)
    failed = s["wrong_status"] > 0 or (s["claim_excess"] or 0) > 0.05
    assert failed, s


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, 3.0e-3, -7.25],
                     dtype=torch.float32)
    r = tf32_round(x)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2.0**-9, float(r[3]), -7.25]
    assert abs(float(r[3]) - 3.0e-3) <= 3.0e-3 * 2.0**-11
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
