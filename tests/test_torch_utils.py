"""The port's utilities against the JAX package's (``utils/``), float64:
``hdot`` / ``hmat``, the debug printers (their text equal to the JAX
printers' on the same data and settings), ``summarize_info`` (the same
dict) and ``time_solve`` and ``trace`` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.qp.types import QPInfo as JaxQPInfo
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu.qp.types import QuadraticProblem as JaxQP
from sqp_solver_tpu.sqp.types import SQPInfo as JaxSQPInfo
from sqp_solver_tpu.sqp.types import SQPSettings as JaxSQPSettings
from sqp_solver_tpu.utils import debug as jax_debug
from sqp_solver_tpu.utils import precision as jax_precision
from sqp_solver_tpu.utils import profiling as jax_profiling
from sqp_solver_tpu_torch.models.problems import simple_qp
from sqp_solver_tpu_torch.qp import QPSettings, qp_solve
from sqp_solver_tpu_torch.qp.types import QPInfo, QuadraticProblem
from sqp_solver_tpu_torch.sqp.types import SQPInfo, SQPSettings
from sqp_solver_tpu_torch.utils import debug, hdot, hmat, is_psd, print_qp, profiling


@pytest.mark.parametrize("sa,sb", [((5,), (5,)), ((3, 5), (5,)), ((3, 5), (5, 4)),
                                   ((2, 3, 5), (5,)), ((2, 3, 5), (6, 5, 4)),
                                   ((2, 3, 5), (2, 5, 4))])
def test_hdot_hmat(sa, sb):
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=sa), rng.normal(size=sb)
    np.testing.assert_allclose(hdot(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.dot(a, b), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(hdot(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jax_precision.hdot(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-13, atol=1e-13)
    if sa[-1] == sb[0] and len(sb) <= 2 or sa[:-2] == sb[:-2]:  # shapes matmul takes
        np.testing.assert_allclose(hmat(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                                   np.asarray(jax_precision.hmat(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-13, atol=1e-13)


def _infos():
    rng = np.random.default_rng(1)
    qp = dict(status=np.array([0, 0, 1, 3, 5], np.int32),
              iter=np.array([25, 50, 1000, 75, 100], np.int32),
              rho_updates=np.array([1, 2, 3, 1, 2], np.int32),
              rho_estimate=rng.uniform(0.01, 1.0, 5), res_prim=rng.uniform(0, 1e-3, 5),
              res_dual=rng.uniform(0, 1e-3, 5))
    sqp = dict(status=np.array([0, 1, 3], np.int32), iter=np.array([3, 100, 7], np.int32),
               qp_solver_iter=np.array([150, 9000, 70], np.int32),
               primal_step_norm=rng.uniform(0, 1e-4, 3), dual_step_norm=rng.uniform(0, 1e-4, 3))
    pairs = [(JaxQPInfo(**{k: jnp.asarray(v) for k, v in qp.items()}),
              QPInfo(**{k: torch.as_tensor(v) for k, v in qp.items()})),
             (JaxSQPInfo(**{k: jnp.asarray(v) for k, v in sqp.items()}),
              SQPInfo(**{k: torch.as_tensor(v) for k, v in sqp.items()}))]
    one = {k: v[0] for k, v in qp.items()}
    pairs.append((JaxQPInfo(**{k: jnp.asarray(v) for k, v in one.items()}),
                  QPInfo(**{k: torch.as_tensor(v) for k, v in one.items()})))
    return pairs


def test_printers_match_jax(capsys):
    a = {k: np.random.default_rng(2).normal(size=s) for k, s in
         dict(P=(3, 3), q=(3,), A=(2, 3), l=(2,), u=(2,)).items()}
    jax_debug.print_qp(JaxQP(**{k: jnp.asarray(v) for k, v in a.items()}))
    want = capsys.readouterr().out
    print_qp(QuadraticProblem(**{k: torch.as_tensor(v) for k, v in a.items()}))
    assert capsys.readouterr().out == want
    for jinfo, pinfo in _infos():
        jax_debug.print_info(jinfo)
        want = capsys.readouterr().out
        debug.print_info(pinfo)
        assert capsys.readouterr().out == want
    for js, ps in ((JaxQPSettings(rho=0.2, polish=True), QPSettings(rho=0.2, polish=True)),
                   (JaxSQPSettings(max_iter=7), SQPSettings(max_iter=7))):
        jax_debug.print_settings(js)
        want = capsys.readouterr().out
        debug.print_settings(ps)
        assert capsys.readouterr().out == want
    for M, psd in ((np.diag([2.0, 0.0]), True), (np.array([[1.0, 2.0], [2.0, 1.0]]), False)):
        assert is_psd(torch.as_tensor(M)) == jax_debug.is_psd(jnp.asarray(M)) == psd


def test_summarize_info_matches_jax():
    for jinfo, pinfo in _infos():
        assert profiling.summarize_info(pinfo) == jax_profiling.summarize_info(jinfo)


def test_time_solve_and_trace_on_cpu(tmp_path):
    qp = simple_qp(device="cpu")
    best, res = profiling.time_solve(qp_solve, qp, QPSettings(), reps=2)
    assert 0.0 < best < 60.0 and int(res.info.status) == 0
    with profiling.trace(str(tmp_path)) as prof:
        qp_solve(qp, QPSettings())
    assert len(prof.key_averages()) > 0
    assert (tmp_path / "trace.json").stat().st_size > 0
