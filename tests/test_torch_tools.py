"""The card tools' host-side pieces, on the CPU: the bit-for-bit comparison
of ``tools/kernel_ab.py`` and the block count its phase split divides by."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from sqp_solver_tpu_torch.tools.kernel_ab import same_bits  # noqa: E402


@pytest.mark.parametrize(
    "a,b,equal",
    [
        (torch.tensor([1.0, float("nan")]), torch.tensor([1.0, float("nan")]), True),
        (torch.tensor([0.0]), torch.tensor([-0.0]), False),
        (torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.0000002]), False),
        (torch.tensor([True, False]), torch.tensor([True, False]), True),
    ],
    ids=["nan-equals-nan", "signed-zeros-differ", "one-ulp-differs", "bool"],
)
def test_same_bits_compares_bit_patterns(a, b, equal):
    assert same_bits(a, b) is equal


class _Lib:
    """A kernel library that reports K3's problems per block."""

    def __init__(self, per):
        self.per = per

    def qp_solve_problems_per_block(self, n, m):
        return self.per if n <= 32 and m <= 64 else 1


@pytest.mark.parametrize(
    "lib,kernel,batch,n,m,blocks",
    [(_Lib(2), "K3", 4095, 32, 33, 2048), (_Lib(2), "K3", 64, 33, 34, 64),
     (object(), "K3", 4096, 32, 33, 4096), (_Lib(2), "K5", 1024, 128, 129, 1024)],
    ids=["warp-layout", "block-layout", "library-without-the-query", "k5"],
)
def test_blocks_of_counts_the_launch_blocks(lib, kernel, batch, n, m, blocks):
    assert cs.blocks_of(lib, kernel, batch, n, m) == blocks
