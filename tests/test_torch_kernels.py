"""The port's two kernels (plain PyTorch versions) against the JAX kernels.

The same numpy inputs, float64, go through the JAX package's Pallas
kernels (``sqp_step_kernel`` and ``polish_kkt_kernel`` in interpret mode
on the CPU, problems on the last axis) and through the port's
``sqp_step_reference`` / ``polish_kkt_reference`` (batch first).
Statuses and flags must agree exactly; iterates to atol 1e-9 (float64
rounding, summed in another order, through up to 200 ADMM iterations);
the adaptive rho values, ratios of residual norms near the float64
floor, to rtol 1e-6.
The factorization count is not compared: the TPU counts it per tile of
problems, the port per problem.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops.qp_kernel import polish_kkt_kernel as jax_polish
from sqp_solver_tpu.ops.qp_kernel import sqp_step_kernel as jax_step
from sqp_solver_tpu.qp.types import QPSettings as JaxQPSettings
from sqp_solver_tpu_torch.ops import qp_kernel as qk
from sqp_solver_tpu_torch.qp.types import QPSettings
from sqp_solver_tpu_torch.testing import polish_inputs, step_inputs

ATOL = 1e-9
SETTINGS = {
    # the main path's inner QP: one rho epoch
    "main": dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                 check_termination=10, warm_start=True, adaptive_rho=True,
                 adaptive_rho_interval=50, schedule="fixed"),
    # rho epochs: adaptive rho adopted at refactor time, early exits
    "epochs": dict(alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, max_iter=200,
                   check_termination=10, adaptive_rho=True, adaptive_rho_interval=20),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_t(a):
    """batch-first numpy -> JAX kernel layout (batch last)"""
    return jnp.asarray(np.moveaxis(a, 0, -1))


def _np(a):
    """JAX kernel layout -> batch-first numpy"""
    return np.moveaxis(np.asarray(a), -1, 0)


def _run_jax_step(a, settings, do_bfgs, minv_in=None, rho_in=None, want_minv=False):
    batch = a["g"].shape[0]
    rho_row = np.zeros(batch) if rho_in is None else rho_in
    msk = np.zeros((8, batch))
    msk[0], msk[1], msk[2], msk[3] = a["reset"], a["upd"], a["active"], rho_row
    out = jax_step(
        _jax_t(a["B"]), _jax_t(a["J"]), _jax_t(a["g"]), _jax_t(a["l"]), _jax_t(a["u"]),
        _jax_t(a["s"]), _jax_t(a["dgl"]), jnp.asarray(msk), _jax_t(a["x"]),
        _jax_t(a["z"]), _jax_t(a["y"]), JaxQPSettings(**settings), do_bfgs=do_bfgs,
        minv_in=None if minv_in is None else _jax_t(minv_in), want_minv=want_minv,
        interpret=True,
    )
    res = dict(p=_np(out[0]), z=_np(out[1]), y=_np(out[2]), B=_np(out[3]))
    st = np.asarray(out[4])  # (9, B)
    res.update(done=st[0] > 0.5, iter=st[1].astype(np.int32), res_prim=st[2],
               res_dual=st[3], fail=st[4] > 0.5, rho_updates=st[5].astype(np.int32),
               rho_estimate=st[6], rho_factor=st[7])
    if want_minv:
        res["minv"] = _np(out[5])
    return res


def _run_port_step(a, settings, do_bfgs, minv_in=None, rho_in=None, want_minv=False):
    out = qk.sqp_step_kernel(
        *(_t(a[k]) for k in ("B", "J", "g", "l", "u", "s", "dgl", "reset", "upd",
                             "active", "x", "z", "y")),
        QPSettings(**settings), do_bfgs=do_bfgs,
        rho_in=None if rho_in is None else _t(rho_in),
        minv_in=None if minv_in is None else _t(minv_in), want_minv=want_minv,
    )
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out._asdict().items()}


def _assert_step_equal(port, ref, active):
    for k in ("done", "iter", "fail", "rho_updates"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in ("p", "z", "y", "B", "res_prim", "res_dual"):
        np.testing.assert_allclose(port[k], ref[k], atol=ATOL, rtol=0, err_msg=k)
    # an adaptive rho is sqrt of a ratio of residual norms that sit near the
    # float64 floor: relative agreement
    for k in ("rho_estimate", "rho_factor"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, err_msg=k)
    if "minv" in ref:
        # the TPU factors a tile whenever any of its problems is active;
        # the port leaves an inactive problem unfactored (Minv 0)
        np.testing.assert_allclose(port["minv"][active], ref["minv"][active], atol=ATOL)
        np.testing.assert_array_equal(port["minv"][~active], 0.0)


@pytest.mark.parametrize("settings", ["main", "epochs"])
@pytest.mark.parametrize("do_bfgs", [True, False])
def test_sqp_step_matches_jax_kernel(settings, do_bfgs):
    """Reset, damped, no-update, posdef-fallback and inactive problems in
    one batch of 8, with an equality row and a loose row each."""
    a = step_inputs(8, 6, 9, seed=11)
    s = SETTINGS[settings]
    port = _run_port_step(a, s, do_bfgs, want_minv=True)
    ref = _run_jax_step(a, s, do_bfgs, want_minv=True)
    _assert_step_equal(port, ref, a["active"])
    assert not port["fail"].any()
    np.testing.assert_array_equal(port["B"][3], np.eye(6))  # posdef fallback
    assert port["n_factor"][3] >= 2 and port["n_factor"][-1] == 0  # inactive: none
    np.testing.assert_array_equal(port["p"][-1], a["x"][-1])  # inactive: frozen
    if settings == "epochs":
        assert port["done"][:-1].any() and (port["rho_updates"] > 1).any()


def test_sqp_step_factor_reuse_matches_jax_kernel():
    """The SOC pair: ``want_minv``, then ``minv_in`` with the emitted rho
    and shifted bounds (no setup factorization)."""
    a = step_inputs(8, 10, 11, seed=5)
    s = SETTINGS["epochs"]
    first = _run_jax_step(a, s, True, want_minv=True)
    b = dict(a, B=first["B"], l=a["l"] - 0.01, u=a["u"] - 0.01, x=first["p"],
             z=first["z"], y=first["y"])
    kw = dict(minv_in=first["minv"], rho_in=first["rho_factor"])
    port = _run_port_step(b, s, False, **kw)
    ref = _run_jax_step(b, s, False, **kw)
    _assert_step_equal(port, ref, a["active"])
    assert (port["n_factor"] < _run_port_step(b, s, False)["n_factor"]).any()


@pytest.mark.parametrize("warm", [False, True])
def test_polish_kkt_matches_jax_kernel(warm):
    """Active-row masking inside the kernel, a non-SPD H (fail flag on
    problem 0), with and without the x0 warm start."""
    a = polish_inputs(6, 8, 10, seed=2)
    x0 = a["x0"] if warm else None
    port = qk.polish_kkt_kernel(
        _t(a["H"]), _t(a["J"]), _t(a["act"]), _t(a["r1"]), _t(a["b"]), _t(a["nu0"]),
        delta=1e-2, sweeps=6, x0=None if x0 is None else _t(x0),
    )
    dx, nu, fail, li = jax_polish(
        _jax_t(a["H"]), _jax_t(a["J"]), _jax_t(a["act"].astype(np.float64)),
        _jax_t(a["r1"]), _jax_t(a["b"]), _jax_t(a["nu0"]), delta=1e-2, sweeps=6,
        x0t=None if x0 is None else _jax_t(x0),
    )
    fail = np.asarray(fail) > 0.5
    np.testing.assert_array_equal(port.fail.numpy(), fail)
    assert fail[0] and not fail[1:].any()
    good = ~fail
    np.testing.assert_allclose(port.x.numpy()[good], _np(dx)[good], atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.nu.numpy()[good], _np(nu)[good], atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.li.numpy()[good], _np(li)[good], atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    a = step_inputs(4, 5, 6, seed=1)
    s = QPSettings(**SETTINGS["main"])
    args = [_t(a[k]) for k in ("B", "J", "g", "l", "u", "s", "dgl", "reset", "upd",
                               "active", "x", "z", "y")]
    before = (qk.sqp_step_launches, qk.polish_kkt_launches)
    got = qk.sqp_step_kernel(*args, s)
    want = qk.sqp_step_reference(*args, s)
    for x, y in zip(got, want):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    p = polish_inputs(4, 5, 6, seed=1)
    pargs = [_t(p[k]) for k in ("H", "J", "act", "r1", "b", "nu0")]
    assert torch.equal(qk.polish_kkt_kernel(*pargs).x, qk.polish_kkt_reference(*pargs).x)
    assert (qk.sqp_step_launches, qk.polish_kkt_launches) == before


def test_wrappers_check_shapes():
    a = step_inputs(4, 5, 6, seed=1)
    args = [_t(a[k]) for k in ("B", "J", "g", "l", "u", "s", "dgl", "reset", "upd",
                               "active", "x", "z", "y")]
    args[1] = args[1][:, :-1]  # J with a row missing
    with pytest.raises(ValueError, match="J has shape"):
        qk.sqp_step_kernel(*args, QPSettings())
