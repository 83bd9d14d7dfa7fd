"""The card tools' host-side pieces, on the CPU: the bit-for-bit comparison
of ``tools/kernel_ab.py``, the block count its phase split divides by, and
the names the tools give to the kernels' phase and arm enums."""

import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sqp_solver_tpu_torch.ops.qp_kernel import _SPD_ARM_NAMES, SPD_ARMS  # noqa: E402
from sqp_solver_tpu_torch.tools.kernel_ab import PHASES, same_bits  # noqa: E402


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
    """A kernel library that reports K3's and K4's problems per block."""

    def __init__(self, per, spd_per=8):
        self.per = per
        self.spd_per = spd_per

    def qp_solve_problems_per_block(self, n, m):
        return self.per if n <= 32 and m <= 64 else 1

    def spd_inverse_problems_per_block(self, n):
        return self.spd_per if n <= 32 else 1


@pytest.mark.parametrize(
    "lib,kernel,batch,n,m,blocks",
    [(_Lib(2), "K3", 4095, 32, 33, 2048), (_Lib(2), "K3", 64, 33, 34, 64),
     (object(), "K3", 4096, 32, 33, 4096), (_Lib(2), "K5", 1024, 128, 129, 1024),
     (_Lib(2), "K4", 4095, 32, 32, 512), (_Lib(2), "K4", 1024, 128, 128, 1024),
     (object(), "K4", 4096, 32, 32, 4096)],
    ids=["warp-layout", "block-layout", "library-without-the-query", "k5",
         "k4-warp-layout", "k4-blocked-layout", "k4-library-without-the-query"],
)
def test_blocks_of_counts_the_launch_blocks(lib, kernel, batch, n, m, blocks):
    assert cs.blocks_of(lib, kernel, batch, n, m) == blocks


def _enum(source: str, name: str) -> list:
    """The enumerators of the C enum ``name`` in a kernel source."""
    text = (ROOT / "sqp_solver_tpu_torch" / "csrc" / source).read_text()
    body = re.search(r"enum " + name + r" \{(.*?)\};", text, re.S).group(1)
    return [e.strip() for e in body.split(",") if e.strip()]


def test_phase_names_follow_the_phase_enum():
    """``kernel_ab.PHASES`` names the phase sums in the order of
    ``AdmmPhase`` (kPhGram .. kPhIter), which the phase clocks index."""
    phases = _enum("admm_core.cuh", "AdmmPhase")
    assert phases[-1] == "kNumPhases"
    assert [p[3:].lower() for p in phases[:-1]] == list(PHASES)


def test_spd_arms_follow_the_launcher_enum():
    """``SPD_ARMS`` gives each of K4's two forced arms, and the arm names
    that ``spd_inverse_arm_info`` reports give each arm, the code of its
    enumerator in ``csrc/qp_kernel.cu:SpdArm`` (0 is the rule's)."""
    arms = _enum("qp_kernel.cu", "SpdArm")
    assert arms[0] == "kSpdRule"
    coded = {a.lower(): i for i, a in enumerate(arms) if i > 0}
    assert {"kspd" + name.replace("-", ""): code for code, name in _SPD_ARM_NAMES.items()} == coded
    assert all(_SPD_ARM_NAMES[code] == name for name, code in SPD_ARMS.items())


def test_anderson_codes_follow_the_launcher_enum():
    """The kernel codes ``ops/qp_kernel.py`` passes to the Anderson
    placement and workspace entries are those of ``csrc/qp_kernel.cu:
    AaKernel``."""
    from sqp_solver_tpu_torch.ops.qp_kernel import _AA_CODES

    codes = dict(e.replace(" ", "").split("=") for e in _enum("qp_kernel.cu", "AaKernel"))
    assert {"kaa" + name.lower().replace("-", ""): code for name, code in _AA_CODES.items()} == {
        name.lower(): int(code) for name, code in codes.items()}


def test_anderson_units_build_with_the_units_they_include():
    """Each Anderson key of the A/B tool names an Anderson unit, which its
    libraries build beside the unit it includes; the step's phases close
    ``PHASES``."""
    from sqp_solver_tpu_torch.tools import kernel_ab as ka

    for key in ka.AA_KERNELS:
        src = ka.SOURCES[key]
        assert src in ka.TWINS and (ROOT / "sqp_solver_tpu_torch" / "csrc" / src).exists()
        assert ka.with_twins([src]) == sorted([src, ka.TWINS[src]])
    assert ka.with_twins(["admm_kernel.cu"]) == ["admm_kernel.cu"]
    assert PHASES[-len(ka.AA_PHASES):] == ka.AA_PHASES
    assert set(ka.AA_KERNELS) <= set(ka.BITS)


def test_anderson_solves_follow_the_step_enum():
    """``ops/qp_kernel.py:AA_SOLVES`` names the codes of ``csrc/admm_core.cuh:
    AaSolve`` in order (the card's placement report gives the code), and the
    A/B tool's forced placements (``-DAA_FORCE_SOLVE=p``) are those codes,
    0 forcing the whole Gram area into shared memory."""
    from sqp_solver_tpu_torch.ops.qp_kernel import AA_SOLVES
    from sqp_solver_tpu_torch.tools import kernel_ab as ka

    codes = dict(e.replace(" ", "").split("=") for e in _enum("admm_core.cuh", "AaSolve"))
    assert [name[len("kAaSolve"):].lower() for name in codes] == list(AA_SOLVES)
    assert [int(v) for v in codes.values()] == list(range(len(AA_SOLVES)))
    assert ka.FORCED == dict(enumerate(AA_SOLVES))
