"""Where the time goes on the serving paths: one traced run per cell.

    python -m sqp_solver_tpu_torch.tools.trace_serving [cell ...]

Runs on the card only, from the root of a checkout (the cells of legs J,
K and M take their settings from ``chip_smoke.py``).  For each cell, after a warm-up, three
unprofiled runs timed on the host clock closed by
``torch.cuda.synchronize()`` and one run under ``torch.profiler`` (CPU
and CUDA activities).  Prints per cell the wall times, the device busy
time (sum of the CUDA kernels' times in the profiled run), the idle
share against the unprofiled and the profiled wall, and the top kernels
by device time:

* qp_one_shot: ``qp_solve_batch(impl="kernel")``, random QPs n = 32,
  m = 33, B = 4096, the one-shot leg's settings, unpolished and polished;
* qp_fused_one_shot: the same QPs through ``qp_solve_batch(impl="fused")``
  (8 launches of the chunk kernel K5 between the library factorizations
  and the per-chunk tensor code);
* mpc_sustained: ``qp_solve_sequence``, K = 10 steps of a B = 4096
  double-integrator fleet, n = 16;
* btd_mpc: ``qp_solve_batch(impl="kernel")`` with
  ``linear_solver="schur_block_tridiag"`` (one launch of K6) on the
  stage-wise MPC QP at horizon 64 (n = 192, m = 320), B = 4096;
* btd_nlp: ``sqp_solve_batch(qp_impl="kernel_btd")`` on the unicycle NLP
  at horizon 32 (n = 128, m = 224), B = 64: 120 outer iterations, each one
  K7 launch among the plain ops of the linearization and line search,
  then 3 polish passes;
* qp_vmap_one_shot: the one-shot QPs through ``qp_solve_batch(impl="vmap")``,
  the per-problem tier's masked loop of plain tensor code;
* sqp_vmap: ``sqp_solve_batch(impl="vmap")`` on the sphere cap, n = 32,
  B = 4096, at the SQP main path's settings (polish through K2);
* family_random_scaled: the random OSQP family (n = 32, m = 48,
  B = 1024) under Ruiz scaling 10 through K3, polished (the families
  leg's settings);
* arrow_vmap: ``schur_arrow`` on the coupled MPC (48 agents of horizon
  16, B = 64, n = 770, m = 1586), 100 iterations on the vmap tier;
* sparse_cg: ``qp_solve`` of ``sparse_qp_pair``'s BlockSparse QP
  (n = m = 4096, blocks of 128, density 0.03) on ``cg``;
* exp_chain_k1: the exponential chain (B = 1024, n = 32) on the K1 tier,
  36 outers;
* qp_diff: ``qp_solve_diff`` forward and backward on the fused tier,
  random QPs B = 1024, n = m = 128;
* sqp_diff: ``sqp_solve_diff`` forward and backward on the exponential
  chain, 24 outers on the K1 tier;
* fused_wide: leg O of ``chip_smoke.py``, ``qp_solve_batch(impl="fused")``
  on random QPs n = m = 640 (D = 1280, K5's wide variant), B = 256, drawn
  on the card: up to 8 K5 launches between the library factorizations;
  also the device time of K5's launches and of the rest.

Name cells on the command line to trace only those (all by default).
The last line is one JSON object with the same numbers and the card's
``name, power.limit``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sqp_solver_tpu_torch.models.mpc import (
    mpc_fleet,
    mpc_nlp_stagewise_batch,
    mpc_qp_stagewise_batch,
    random_qp_batch,
)
from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
from sqp_solver_tpu_torch.qp import QPSettings, qp_solve_sequence
from sqp_solver_tpu_torch.sqp import SQPSettings

SETTINGS = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200, check_termination=25,
                      adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed")


def _mpc_rollout(dev, B=4096, H=16, K=10):
    make_qp, step = mpc_fleet(B, horizon=H, dt=0.1, device=dev)

    def advance(st, r):
        return step(st, r.x[:, 0]), (r.info.status == 0).float().mean()

    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-1.0, 1.0, size=(B, 2)),
                         dtype=torch.float32).to(dev)
    return lambda: qp_solve_sequence(make_qp, advance, x0, K, SETTINGS, impl="kernel")


def _btd_nlp(dev):
    """The structured NLP cell (the JAX package's bench.py:586-595)."""
    settings = SQPSettings(
        max_iter=120, eps_prim=1e-4, eps_dual=1e-4, termination="kkt", schedule="fixed",
        polish=True, polish_passes=3, line_search_max_iter=16, qp_impl="kernel_btd",
        qp=QPSettings(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=300,
                      check_termination=25, warm_start=True, adaptive_rho=True,
                      adaptive_rho_interval=50, block_size=4))
    problem, x0, _ = mpc_nlp_stagewise_batch(64, horizon=32, device=dev)
    return lambda: sqp_solve_batch(problem, x0, None, settings, impl="fused")


def _sqp_vmap(dev):
    """The SQP main path's n = 32 configuration on the per-problem tier."""
    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch

    settings = SQPSettings(
        max_iter=3, eps_prim=2e-3, eps_dual=2e-3, termination="kkt", schedule="fixed",
        polish=True, polish_passes=2, line_search_max_iter=5,
        qp=QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                      check_termination=10, warm_start=True, adaptive_rho=True,
                      adaptive_rho_interval=50, schedule="fixed"))
    problem, x0 = sphere_cap_nlp_batch(4096, 32, seed=3, device=dev)
    return lambda: sqp_solve_batch(problem, x0, None, settings, impl="vmap")


def _family_random(dev):
    """The families leg's random class (bench.py:1061-1067) through K3."""
    from sqp_solver_tpu_torch.models.families import random_qp_batch_device

    settings = dataclasses.replace(SETTINGS, max_iter=300, schedule="fixed", polish=True,
                                   scaling=10)
    qp = random_qp_batch_device(0, 1024, 32, 48, device=dev)
    return lambda: qp_solve_batch(qp, settings, impl="kernel")


def _arrow(dev):
    """The arrow row of the JAX package's bench.py:671-681."""
    from sqp_solver_tpu_torch.models.mpc import mpc_qp_coupled_batch

    qp, blk, cw = mpc_qp_coupled_batch(64, agents=48, horizon=16, device=dev)
    settings = QPSettings(adaptive_rho=True, max_iter=100, linear_solver="schur_arrow",
                          block_size=blk, arrow_width=cw)
    return lambda: qp_solve_batch(qp, settings, impl="vmap")


def _sparse_cg(dev):
    """The sparse row of the JAX package's bench.py:735-746."""
    from chip_smoke import sparse_cg_settings  # leg J's settings
    from sqp_solver_tpu_torch.models.sparse import sparse_qp_pair
    from sqp_solver_tpu_torch.qp import qp_solve

    _, sparse = sparse_qp_pair(4096, 4096, 128, 0.03, seed=0, device=dev)
    return lambda: qp_solve(sparse, sparse_cg_settings())


def _exp_chain(dev):
    from chip_smoke import multi_outer_settings  # leg K's settings
    from sqp_solver_tpu_torch.models.benchmark import exp_chain_nlp_batch_device

    problem, x0 = exp_chain_nlp_batch_device(1, 1024, 32, device=dev)
    settings = multi_outer_settings("exp_chain")
    return lambda: sqp_solve_batch(problem, x0, None, settings, impl="fused")


def _qp_diff(dev):
    """bench.py:1188-1207: forward and backward through the fused tier."""
    from sqp_solver_tpu_torch.models.families import random_qp_batch_device
    from sqp_solver_tpu_torch.qp import QuadraticProblem, qp_solve_diff

    qp = random_qp_batch_device(1, 1024, 128, 128, device=dev)
    settings = dataclasses.replace(SETTINGS, eps_abs=1e-5, eps_rel=1e-5, polish=True)

    def run():
        leaves = {k: getattr(qp, k).detach().requires_grad_(True) for k in "PqAlu"}
        x = qp_solve_diff(QuadraticProblem(**leaves), settings, "fused")
        (x * x).sum().backward()

    return run


def _sqp_diff(dev):
    """bench.py:1335-1352: forward and backward on the K1 tier."""
    from chip_smoke import multi_outer_settings  # leg M's settings
    from sqp_solver_tpu_torch.models.benchmark import exp_chain_nlp_batch_device
    from sqp_solver_tpu_torch.sqp import sqp_solve_diff

    problem, x0 = exp_chain_nlp_batch_device(1, 1024, 32, device=dev)
    settings = multi_outer_settings("sqp_diff")

    def run():
        p = dataclasses.replace(problem, **{k: getattr(problem, k).detach().requires_grad_(True)
                                            for k in ("l", "u", "params")})
        x = sqp_solve_diff(p, x0, None, settings, "fused")
        (x * x).sum().backward()

    return run


def _fused_wide(dev):
    from sqp_solver_tpu_torch.models.families import random_qp_batch_device

    qp = random_qp_batch_device(torch.Generator(device=dev).manual_seed(640), 256, 640, 640)
    return lambda: qp_solve_batch(qp, SETTINGS, impl="fused")


def _trace(fn) -> dict:
    """Unprofiled wall (min of 3 after a warm-up), then one profiled run:
    device busy time is the sum over CUDA kernel events only (an aten op's
    own record would count its kernel twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    k5_ms = sum(us for us, _, k in rows if "admm_chunk" in k) / 1e3
    return dict(wall_ms=wall * 1e3, walls_ms=[w * 1e3 for w in walls],
                wall_profiled_ms=wall_prof * 1e3, device_busy_ms=busy_ms,
                device_launches=sum(r[1] for r in rows),
                idle_share=1.0 - busy_ms / (wall * 1e3),
                idle_share_profiled=1.0 - busy_ms / (wall_prof * 1e3),
                k5_ms=k5_ms, k5_launches=sum(c for _, c, k in rows if "admm_chunk" in k),
                top=[dict(name=k[:60], count=c, ms=us / 1e3) for us, c, k in rows[:12]])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("trace_serving: no CUDA device; this script runs only on the GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    qp = random_qp_batch(4096, 32, 33, seed=0, device=dev)
    polished = dataclasses.replace(SETTINGS, polish=True)
    btd = QPSettings(adaptive_rho=True, max_iter=100, schedule="fixed",
                     linear_solver="schur_block_tridiag", block_size=3)
    mpc_btd, _ = mpc_qp_stagewise_batch(4096, horizon=64, device=dev)
    makers = {
        "qp_one_shot": lambda: (lambda: qp_solve_batch(qp, SETTINGS, impl="kernel")),
        "qp_one_shot_polished": lambda: (lambda: qp_solve_batch(qp, polished, impl="kernel")),
        "qp_fused_one_shot": lambda: (lambda: qp_solve_batch(qp, SETTINGS, impl="fused")),
        "mpc_sustained": lambda: _mpc_rollout(dev),
        "btd_mpc": lambda: (lambda: qp_solve_batch(mpc_btd, btd, impl="kernel")),
        "btd_nlp": lambda: _btd_nlp(dev),
        "qp_vmap_one_shot": lambda: (lambda: qp_solve_batch(qp, SETTINGS, impl="vmap")),
        "sqp_vmap": lambda: _sqp_vmap(dev),
        "family_random_scaled": lambda: _family_random(dev),
        "arrow_vmap": lambda: _arrow(dev),
        "sparse_cg": lambda: _sparse_cg(dev),
        "exp_chain_k1": lambda: _exp_chain(dev),
        "qp_diff": lambda: _qp_diff(dev),
        "sqp_diff": lambda: _sqp_diff(dev),
        "fused_wide": lambda: _fused_wide(dev),
    }
    names = sys.argv[1:] or list(makers)
    unknown = set(names) - set(makers)
    if unknown:
        raise SystemExit(f"trace_serving: unknown cells {sorted(unknown)}; cells: {list(makers)}")
    cells = {name: _trace(makers[name]()) for name in names}
    for name, c in cells.items():
        print(f"{name}: wall {c['wall_ms']:.3f} ms (min of 3; profiled "
              f"{c['wall_profiled_ms']:.3f}), device busy {c['device_busy_ms']:.3f} ms in "
              f"{c['device_launches']} kernels, idle share {c['idle_share']:.3f} of the "
              f"unprofiled wall ({c['idle_share_profiled']:.3f} of the profiled); K5 "
              f"{c['k5_ms']:.3f} ms in {c['k5_launches']} launches, the rest "
              f"{c['device_busy_ms'] - c['k5_ms']:.3f} ms [{card}]")
        for t in c["top"]:
            print(f"    {t['ms']:8.3f} ms  x{t['count']:<4d} {t['name']}")
    print(json.dumps(dict(cells=cells, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
