"""The benchmark's CPU tests: the repository root on the path, and a
small version of every cell (the configuration's class at a few states,
a few problems a batch) so that a run fits a test."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SMALL = dict(config=dict(nx=4, nu=2, horizon=4, stage_block=6),
             traffic=dict(batch=4, pool_batches=2, trace_seconds=0.3))


@pytest.fixture
def small():
    return SMALL


@pytest.fixture
def bench():
    from perfbench.harness import load_bench

    return load_bench()
