"""The OSQP-paper families on the whole-QP kernel's tier (K3's plain
version) against the JAX package's K3 in interpret mode: each family at
the families leg's settings (``bench.py:1061-1065``: scaling 10, 300
iterations, fixed schedule, polish), B = 4, float64, statuses and counts
equal and x, y, z within 1e-9.  The generators and the vmap tier:
``tests/test_torch_families.py``."""

import pytest

from test_torch_families import SOLVE, _solve_both


@pytest.mark.parametrize("name", list(SOLVE))
def test_family_solves_on_the_kernel_tier_as_jax_does(name):
    _solve_both(name, "kernel")
