"""The fused ADMM chunk (K5) past the narrow kernel's shapes (D = n + m
from 289 to 2125: the cluster and stream routes), against the JAX package.

The same numpy inputs, float64, B = 2, seg 3, go through the port's plain
version ``admm_chunk_reference`` (the oracle that the card holds the
kernel's routes to) and the JAX package's ``admm_chunk_xla``, at odd Ds
(289, 1025: no problem's W after the first starts 16-byte aligned) and
even ones (512; 960, the OSQP control class's dense shape; 1100; 2125,
the JAX kernel's limit), each with an equality row and a loose row.
Tolerance: atol = rtol = 1e-12 (float64 summed in another order over
three iterations of a D x D product).

Then the wide layout's rule, which ``ops/admm_kernel.py:admm_chunk_wide_layout``
mirrors from ``csrc/admm_kernel.cu:wide_layout`` (the card's tests hold the
two equal): the most blocks a problem, up to 8, that leave every block an
SM of its own (one where the batch alone outnumbers the SMs),
each block's rows of W are a contiguous range and the ranges cover D, the
stages hold whole rows of W, and shared memory fits the blocks an SM.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqp_solver_tpu.ops import admm_kernel as jax_ak
from sqp_solver_tpu_torch.ops import admm_kernel as ak
from sqp_solver_tpu_torch.testing import admm_chunk_inputs

CHUNK_ARGS = ("W", "P", "A", "qv", "scale1", "rhoip", "rhop", "lp", "up", "s", "yp")


@pytest.mark.parametrize(
    "n,m", [(500, 525), (512, 588), (145, 144), (256, 256), (360, 600), (1062, 1063)],
    ids=["D1025-odd", "D1100", "D289-odd", "D512", "D960-control", "D2125"])
def test_admm_chunk_reference_matches_jax_at_wide_shapes(n, m):
    a = admm_chunk_inputs(2, n, m, seed=n, equality_row=True, loose_row=True)
    launches = ak.admm_chunk_launches
    out = ak.admm_chunk(*(torch.as_tensor(a[k]) for k in CHUNK_ARGS), alpha=1.6, seg=3)
    assert ak.admm_chunk_launches == launches  # CPU tensors take the plain version
    ref = jax_ak.admm_chunk_xla(*(jnp.asarray(a[k]) for k in CHUNK_ARGS), alpha=1.6, seg=3)
    for name, x, y in zip(("s", "yp", "stats"), out, ref):
        assert x.dtype == torch.float64
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-12, rtol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize(
    "n,m,batch,sms",
    [(640, 640, 256, 132), (1024, 1024, 64, 132), (513, 600, 3, 132), (1024, 1024, 256, 132),
     (2047, 1, 5, 132), (1, 2047, 1000, 132), (700, 700, 40, 114), (1062, 1063, 64, 132)],
    ids=["D1280-B256", "D2048-B64", "D1113-B3", "D2048-B256", "m1", "n1", "B40-114SMs",
         "D2125-B64"])
def test_admm_chunk_wide_layout_rule(n, m, batch, sms):
    D = n + m
    lay = ak.admm_chunk_wide_layout(n, m, batch, sms=sms)
    c = lay["cluster"]
    assert c in (1, 2, 4, 8)
    # the most blocks a problem (up to 8) that leave every block an SM of its own
    assert batch * c <= sms or c == 1
    assert c == 8 or batch * 2 * c > sms
    ranges = lay["row_ranges"]
    assert len(ranges) == c and ranges[0][0] == 0 and ranges[-1][1] == D
    assert all(r1 == s0 for (_, r1), (s0, _) in zip(ranges, ranges[1:]))
    assert max(r1 - r0 for r0, r1 in ranges) <= lay["rows_max"]
    # whole rows of W a stage, with room for the 16-byte aligned window
    assert lay["rows_stage"] >= 1
    assert lay["stage_floats"] >= lay["rows_stage"] * D + 6 and lay["stage_floats"] % 4 == 0
    assert lay["device_rows"] == D and lay["w_bytes_per_iteration"] == 4 * D * D
    # shared memory: a block's within the card's 227 KB, the blocks an SM within its 228 KB
    assert lay["smem_bytes"] <= 232448
    assert lay["blocks_per_sm"] * (lay["smem_bytes"] + 1024) <= 233472
    assert lay["blocks_per_sm"] == (2 if batch * c > sms else 1)


def test_admm_chunk_wide_layout_forced_cluster_and_refusals():
    for c in (1, 2, 4, 8):
        lay = ak.admm_chunk_wide_layout(1024, 1024, 64, cluster=c)
        assert lay["cluster"] == c and lay["blocks"] == 64 * c
    with pytest.raises(ValueError):
        ak.admm_chunk_wide_layout(512, 512, 4)  # D = 1024: the narrow kernel's
    assert ak.admm_chunk_wide_layout(1062, 1063, 4)["rows_max"] == 266  # D = 2125, clusters of 8
    with pytest.raises(ValueError):
        ak.admm_chunk_wide_layout(1063, 1063, 4)  # D = 2126: past the JAX kernel's limit
    with pytest.raises(ValueError):
        ak.admm_chunk_wide_layout(1024, 1024, 4, cluster=3)
