"""The port's reference-semantics tier against the C++/Eigen reference at
1e-6, as ``tests/test_conformance.py`` holds the JAX package (no JAX here).

The goldens in ``golden/reference_golden.json`` come from the reference
library run on every fixture at tight tolerances; at the same tight
settings the port's per-problem ``qp_solve`` / ``sqp_solve`` (float64, on
the CPU) must land within 1e-6 of them, and from the infeasible start
where the reference stalls, within 1e-6 of the analytic optimum.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sqp_solver_tpu_torch.models.problems import (
    constrained_rosenbrock_2d,
    rosenbrock_box,
    simple_nlp,
    simple_nlp2,
    simple_qp,
    simple_qp_nlp,
)
from sqp_solver_tpu_torch.qp import QPSettings, qp_solve
from sqp_solver_tpu_torch.sqp import SQPSettings, sqp_solve

with open(os.path.join(os.path.dirname(__file__), "golden", "reference_golden.json")) as f:
    GOLDEN = json.load(f)

# tests/test_conformance.py's tight regime: moderate inner-QP eps, outer
# accuracy from KKT-residual termination at 1e-7
TIGHT = SQPSettings(
    max_iter=300,
    eps_prim=1e-7,
    eps_dual=1e-7,
    termination="kkt",
    qp=QPSettings(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=2000, check_termination=25,
                  warm_start=True, adaptive_rho=True, adaptive_rho_interval=50),
)
QP_TIGHT = QPSettings(eps_abs=1e-10, eps_rel=1e-10, max_iter=100000)


def _against(ours, key_or_vec, tol=1e-6):
    target = GOLDEN["reference"][key_or_vec] if isinstance(key_or_vec, str) else key_or_vec
    err = np.max(np.abs(ours.numpy() - np.asarray(target)))
    assert err <= tol, f"max |x - x_ref| = {err:.3e} > {tol}"


def _vec(values):
    return torch.tensor(values, dtype=torch.float64)


def test_simple_qp_vs_reference_tight():
    res = qp_solve(simple_qp(device="cpu"), QP_TIGHT)
    _against(res.x, "simple_qp_x")
    _against(res.x, GOLDEN["analytic"]["simple_qp"])


def test_simple_qp_duals_vs_reference():
    res = qp_solve(simple_qp(device="cpu"), QP_TIGHT)
    _against(res.y, "simple_qp_y", tol=1e-5)


CASES = [
    # (name, problem constructor, x0, multipliers, SOC, golden key)
    ("simple_nlp_feasible", simple_nlp, [1.2, 0.1], 3, True, "simple_nlp_feasible_x_tight"),
    ("simple_qp_nlp", simple_qp_nlp, [0.0, 0.0], 3, True, "simple_qp_nlp_x_tight"),
    ("rosenbrock_2d", constrained_rosenbrock_2d, [0.0, 0.0], 2, False, "rosenbrock_2d_x_tight"),
    ("rosenbrock_box_2", lambda device: rosenbrock_box(2, device=device), [0.0, 0.0], 2, False,
     "rosenbrock_box_2_x_tight"),
    ("rosenbrock_box_3", lambda device: rosenbrock_box(3, device=device), [0.0, 0.0, 0.0], 3,
     False, "rosenbrock_box_3_x_tight"),
    ("simple_nlp_nosoc", simple_nlp, [1.2, 0.1], 3, False, "simple_nlp_nosoc_x_tight"),
    ("simple_nlp2", simple_nlp2, [1.2, 0.1], 1, False, "simple_nlp2_x_tight"),
]


@pytest.mark.parametrize("name,ctor,x0,nlam,soc,key", CASES, ids=[c[0] for c in CASES])
def test_sqp_tight_agreement(name, ctor, x0, nlam, soc, key):
    settings = dataclasses.replace(TIGHT, second_order_correction=soc)
    res = sqp_solve(ctor(device="cpu"), _vec(x0), torch.zeros(nlam, dtype=torch.float64),
                    settings)
    _against(res.x, key)


def test_infeasible_start_beats_stalled_reference():
    """From the infeasible start the reference's tight run stalls at a
    non-KKT point (flagged in the goldens); the port reaches [1, 1]."""
    settings = dataclasses.replace(TIGHT, second_order_correction=True)
    res = sqp_solve(simple_nlp(device="cpu"), _vec([2.0, -1.0]),
                    torch.ones(3, dtype=torch.float64), settings)  # tests/sqp_test.cpp:76
    _against(res.x, GOLDEN["analytic"]["simple_nlp"], tol=1e-6)
