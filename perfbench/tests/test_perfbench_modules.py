"""A run loads neither JAX nor the JAX package, compared by whole
top-level module name, and the command refuses to run without a card."""

import os
import subprocess
import sys

import pytest

from perfbench.harness import FORBIDDEN, forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = """
import sys, time
sys.path.insert(0, {root!r})
from perfbench.harness import forbidden_modules, load_bench, run_cell
from perfbench.tests.conftest import SMALL
for cell in ("control12-cold", "control50-wave"):
    for trace in (False, True):
        run_cell(load_bench(), cell, 5, 0.1, trace, "cpu", time.time(), overrides=SMALL)
import perfbench.control, perfbench.reference.admm
tops = {{k.split(".")[0] for k in sys.modules}}
print(sorted(k for k in tops if k.startswith(("jax", "sqp", "flax"))))
print(forbidden_modules())
"""


def test_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, leaked = out.stdout.strip().splitlines()[-2:]
    assert "sqp_solver_tpu_torch" in loaded
    assert leaked == "[]"


def test_names_compared_whole():
    assert forbidden_modules(["sqp_solver_tpu_torch", "sqp_solver_tpu_torch.ops", "jaxtyping",
                              "flaxen", "torch"]) == []
    assert forbidden_modules(["sqp_solver_tpu.qp", "jaxlib.xla_client", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "sqp_solver_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "sqp_solver_tpu"}


def test_command_needs_a_card():
    """Without a CUDA card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "control12-cold",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the smallest cell on the card: exit 0, correct, the
    line's metrics the cell's (``pytest -m gpu perfbench/tests`` there)."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "control50-wave",
                          "--seed", str(2**31 + 31), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and set(line["metrics"]) == {
        "solves_per_s", "batch_ms_p95", "setup_s"}


@pytest.mark.gpu
def test_benchmark_alone_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    command exits non-zero and prints no result, on the card too."""
    import shutil

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "control50-wave",
                          "--seed", str(2**31 + 37), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
