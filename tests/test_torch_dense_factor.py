"""The plain twin of the blocked dense factor of K1 and K2.

``_chol_inv_blocked`` follows the order of ``csrc/dense_factor.cuh``: the
Cholesky in panels of 32 columns and L^-1 by 32 x 32 blocks.  Here, in
float64, it is held against the port's column factor ``_chol_inv_ltl``
(the oracle of the plain K1-K4) and against the JAX package's kernels
that run JAX's ``_chol_inv_ltl`` in interpret mode on the CPU: Minv
against ``spd_inverse_kernel``, L^-1 against ``polish_kkt_kernel``'s
``li``.  Sizes below, at and across a panel (partial panels included);
fail flags must be equal, values agree to 1e-9 (float64 sums in another
order), and to rtol 1e-9 where a clamped pivot makes them ~1e15.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel import polish_kkt_kernel as jax_polish
from sqp_solver_tpu.ops.qp_kernel import spd_inverse_kernel as jax_spd_inverse
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.testing import polish_inputs, spd_inputs

ATOL = 1e-9
SIZES = [6, 32, 33, 50, 100]


def _jax_t(a):
    return jnp.asarray(np.moveaxis(a, 0, -1))


def _np(a):
    return np.moveaxis(np.asarray(a), -1, 0)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_twin_matches_column_factor(n):
    """Minv and L^-1 of the twin against ``_chol_inv_ltl``, with a non-SPD
    problem 0."""
    M = torch.as_tensor(spd_inputs(4, n, seed=n)["M"])
    for ltl in (True, False):
        out, fail = qk._chol_inv_blocked(M, ltl=ltl)
        ref, rfail = qk._chol_inv_ltl(M, ltl=ltl)
        assert torch.equal(fail, rfail) and bool(fail[0]) and not fail[1:].any()
        torch.testing.assert_close(out[1:], ref[1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_twin_minv_matches_jax_spd_inverse(n):
    a = spd_inputs(3, n, seed=n + 1)
    Minv, fail = qk._chol_inv_blocked(torch.as_tensor(a["M"]))
    jm, jf = jax_spd_inverse(_jax_t(a["M"]))
    jf = np.asarray(jf) > 0.5
    np.testing.assert_array_equal(fail.numpy(), jf)
    assert jf[0] and not jf[1:].any()
    np.testing.assert_allclose(Minv.numpy()[1:], _np(jm)[1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_twin_li_matches_jax_polish_kkt(n):
    """L^-1 of the polish Schur matrix H + delta I + (1/delta) Jm'Jm."""
    a = polish_inputs(3, n, n + 1, seed=n + 2)
    act = a["act"].astype(np.float64)
    Jm = torch.as_tensor(a["J"] * act[..., None])
    M = qk._schur_matrix(torch.as_tensor(a["H"]), Jm, torch.as_tensor(act) * 1e2, 1e-2)
    Li, fail = qk._chol_inv_blocked(M, ltl=False)
    _, _, jf, jli = jax_polish(
        _jax_t(a["H"]), _jax_t(a["J"]), _jax_t(act), _jax_t(a["r1"]), _jax_t(a["b"]),
        _jax_t(a["nu0"]), delta=1e-2, sweeps=1,
    )
    jf = np.asarray(jf) > 0.5
    np.testing.assert_array_equal(fail.numpy(), jf)
    assert jf[0] and not jf[1:].any()
    np.testing.assert_allclose(Li.numpy()[1:], _np(jli)[1:], atol=ATOL, rtol=0)


def test_blocked_twin_fail_flags_and_clamped_pivot():
    """An indefinite pivot in the second panel, a NaN, and a zero pivot
    that is clamped to 1e-30 (fail set, values finite and equal to the
    column factor's and the JAX kernel's)."""
    n = 50
    M = np.broadcast_to(np.eye(n) * 2.0, (4, n, n)).copy()
    M[0, 35, 35] = -1.0  # indefinite, second panel
    M[1, 20, 20] = np.nan
    M[2, 40, 40] = 0.0  # clamped pivot: L_40,40 = 1e-15
    out, fail = qk._chol_inv_blocked(torch.as_tensor(M))
    ref, rfail = qk._chol_inv_ltl(torch.as_tensor(M))
    assert fail.tolist() == [True, True, True, False] == rfail.tolist()
    assert torch.isfinite(out[2]).all() and float(out[2, 40, 40]) == pytest.approx(1e30)
    for k in (0, 2, 3):
        torch.testing.assert_close(out[k], ref[k], atol=ATOL, rtol=1e-9)
    jm, jf = jax_spd_inverse(_jax_t(M))
    np.testing.assert_array_equal(np.asarray(jf) > 0.5, fail.numpy())
    np.testing.assert_allclose(out.numpy()[2:], _np(jm)[2:], atol=ATOL, rtol=1e-9)
