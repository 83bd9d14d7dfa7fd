#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device facts: ``nvidia-smi`` name and power limit, torch, CUDA, nvcc;
2. build the CUDA kernels from ``sqp_solver_tpu_torch/csrc`` (one nvcc
   per source, all started together), and meanwhile copies of the sources
   of K1-K4, of K5 and of the wide K6/K7 with phase clocks
   (``-DADMM_PHASE_CLOCKS``);
3. each kernel against its plain PyTorch version on the card, in float32,
   at its paths' shapes, with both times from CUDA events: the SQP-step
   (K1) and polish-KKT (K2) kernels at n = 32, B = 4096 and n = 128,
   B = 1024; the whole-QP kernel (K3) on random QPs (n = 32, m = 33) and
   the MPC family (n = 16, m = 32), B = 4096, in the layout its rule takes
   there (one warp a problem) and timed in the other (one block a
   problem), plus a batch of primal- and dual-infeasible QPs; the
   SPD-inverse kernel (K4) at n = 32, B = 4096 (one warp a problem) and
   n = 128, B = 1024 (the blocked factor in place, also held against the
   plain twin of its blocked order), its launch's registers, shared
   memory and blocks an SM as the runtime reports them, timed in turns
   with ``torch.linalg.cholesky_ex`` + ``torch.cholesky_inverse``, its
   library yardstick (median and spread of the turns); the ADMM chunk
   kernel (K5), one chunk, at n = 32, m = 33, B = 4096 (seg 10 and 25),
   n = 16, m = 32, B = 4096 (seg 25) and n = 128, m = 129, B = 1024
   (seg 10, the rows of W that shared memory cannot hold in registers),
   with the rows of W in shared memory and in registers, and past
   D = 1024 (the wide variant: W streamed from device memory through a
   ring of bulk copies, a cluster of blocks a problem) at n = m = 640,
   B = 256 and n = m = 1024, B = 64, drawn on the card, with its layout
   (cluster, stages, blocks an SM), its rate and its time with clusters of
   1, 2 and 4 forced; at the middle sizes (the cluster route, W on chip
   across a cluster for the whole chunk, or the stream route) at n = m =
   256, B = 1024 (seg 25 and 10) and n = 360, m = 600, B = 256 (seg 25),
   with the route, the rows of W on chip, the bytes of W an iteration
   reads from device memory and the time with every other route and
   cluster that fits forced; at the JAX kernel's limit D = 2125 (B = 64);
   every K5 row with its streaming floor (W read every
   iteration) and its share of it; K2 with factor
   reuse (n = 128, B = 1024, a tenth of the masks changed) against its
   plain version, and on unchanged masks bit for bit the fresh kernel; the phase split
   of K1, K2, K3, K4 and K5 in cycles per block (the wide K5 also thread
   0's cycles an iteration on the ring, the dots and the exchange); the time of the fused
   tier's library factorization at n = 32 and n = 128; the structured
   kernel's QP entry (K6) on random block-tridiagonal QPs without equality
   rows (n = 192, m = 320, B = 4096, one rho epoch, atol = rtol = 1e-4)
   and, with rho epochs, on the stage-wise MPC family at horizon 64
   (B = 256 and 4096), where the kernel and the plain float32 version are
   each held against the plain float64 version at ``EPOCH_TOL``; its SQP
   step entry (K7) likewise on the unicycle NLP's first-iteration QPs at
   horizons 32 and 48 (B = 64); for each K6/K7 shape the block layout the
   launcher took (one block or a cluster of two per problem), the rows of
   A on chip and the time per ADMM iteration, and the same launch in the
   other layout held against the same plain version and timed; the
   wide structured kernel (internal blocks from 40,
   ``csrc/qp_kernel_btd_wide.cu``): K6 on the OSQP control class's 6-DOF
   arm (``testing.control_qp_inputs``, n = 360, m = 600, internal block
   40, B = 1024) against float64 as the MPC rows, and at a fixed rho for
   200 iterations within twice the plain float32 version's error against
   float64 (the arm's trajectories never meet float64's counts), on
   random band QPs at internal blocks 64 and 128 (at 64 also with
   Anderson in chunks of 10, against float64 as in leg G, within twice the
   plain float32 version's difference) and, at 40 (n = 360, m = 600,
   B = 64), on a batch in which every eighth problem has a row across three
   column blocks (the kernel's dense route; the others its band rows),
   whose routes must equal ``band_rows``' and the wrapper's tally, each
   route held against the plain version; and K7 on random band QPs at the
   structured NLP's block-64 shape (n = 128, m = 224, B = 64, the shape of
   phase 9's 120 wide launches) and at 40 (n = 360, m = 600, B = 64); each
   wide row with its routes, cluster, shared memory a block, the arrays
   there and in device memory, the bytes an ADMM iteration reads from
   device memory, and its bound on A's nonzeros beside the bound on dense
   A (the Anderson row too); past internal block 128 (the compact route:
   A by its nonzeros, the layout rule's cluster), K6 on random band QPs at
   136 (n = 272, m = 160, B = 128) and 256 (n = 512, m = 200, B = 32; a
   matrix of the sweeps outgrows a block) and K7 at 136 (B = 64) and 256
   (B = 32), each against its plain version and float64, and K7 at the
   control class's shape at 50 states (internal block 152, B = 16) at a
   fixed rho against float64 as the arm; then the wide kernel's phase
   split at the arm's and K7's shapes and at leg P's (B = 16);
4. the SQP main path end to end, ``sqp_solve_batch(impl="fused")`` on the
   sphere-cap family at the two benchmark configurations, checked against
   the closed-form optimum and an independent float64 KKT certificate,
   with ``qp_impl="kernel"`` (K1, K2) and ``qp_impl="fused"`` (K5, K2);
5. one-shot QP serving, ``qp_solve_batch`` on random QPs (n = 32, m = 33,
   B = 4096): ``impl="kernel"`` unpolished and polished through K2 and
   through the K4 route, ``impl="fused"`` unpolished and polished through
   K2, each checked by a float64 OSQP termination test and KKT error
   computed in numpy; then a batch of feasible, primal- and
   dual-infeasible QPs through the fused tier, whose statuses must equal
   K3's;
6. sustained MPC serving, ``qp_solve_sequence``: K = 10 warm-started
   steps of a B = 4096 double-integrator fleet (n = 16) through K3, then a
   probe sequence of 5 ADMM iterations per step that holds each warm
   step's residual against a cold solve of the same QP; the same K = 10
   steps through the fused tier;
7. sustained NLP serving, ``sqp_solve_sequence``: one cold sphere-cap
   solve (n = 32, B = 4096) and 8 warm steps, the last step certified in
   float64;
8. the structured MPC QP, ``qp_solve_batch(impl="kernel")`` with
   ``linear_solver="schur_block_tridiag"`` (one K6 launch) on the
   stage-wise MPC at horizon 64, B = 256 and 4096, against the dense K3 on
   the same problems: statuses, x where both solved, and the float64 OSQP
   test of every SOLVED problem;
9. the structured NLP, ``sqp_solve_batch(qp_impl="kernel_btd")`` on the
   unicycle family at horizon 32, B = 64 (120 K7 and 3 K2 launches; 240 K7
   with the second-order correction; at block 64, 120 of the wide K7),
   against the dense kernel tier (K1), every SOLVED problem certified in
   float64;
10. the reference-semantics tier, ``impl="vmap"`` (legs A-D), whose ADMM
   chunks are plain tensor code and whose masked loops cost one host check
   a trip (each leg prints its count): A. one-shot QP serving on the same
   random QPs as phase 5, unpolished (no launch) and polished (K2 per
   pass), with phase 5's bars; B. the SQP main path's two configurations
   with phase 4's bars (K2 per polish pass only); C. in phase 8, the dense
   vmap row of bench.py:512 at B = 256 beside K6 and K3, every SOLVED
   problem passing the float64 OSQP test; D. phase 6's sustained MPC;
11. E. the five OSQP families (bench.py:1040-1072) at B = 1024, drawn on
   the card, under Ruiz scaling 10 through K3 (the random class also
   through the vmap and fused tiers), each class's float64 OSQP test
   against the unscaled problem >= 0.99;
12. F. the K1 SQP tier under inner-QP scaling (n = 32, B = 4096,
   ``qp.scaling=10``): BFGS outside the kernel, K1 with ``do_bfgs=False``,
   phase 4's bars;
13. G. Anderson acceleration inside the whole-solve kernels, each path
   beside the same call with ``acceleration="none"`` (walls min of 3, mean
   ADMM iterations, solved fraction): K3 on random QPs n = 32, m = 33,
   B = 4096 at bench.py:1387-1396's settings (the float64 OSQP test);
   the SQP main path n = 32, B = 4096 with ``qp.acceleration="anderson"``
   through K1 (phase 4's bars); K6 on the structured MPC at horizon 64,
   B = 256; K7 on one structured NLP step (horizon 32, B = 64).  Each
   kernel with Anderson and its plain version with Anderson in float32 are
   held against the plain version in float64 (``EPOCH_TOL`` where the
   counts agree; the kernel's counts agreeing on >= 0.9 of what plain
   float32 keeps) and timed with and without Anderson beside the bound.
   K6 (on a cluster) and K7 also with chunks of 10 iterations and rho
   every 50, where the ring holds several pairs: Anderson must change
   the iteration counts of some problems and a quarter of them must reach
   a Gram of two pairs (at the cells' own settings the ring holds one
   pair at most, so those rows time the step's overhead); then each
   Anderson kernel (K1, K3 in both layouts, K6, K7 and the wide K6 and
   K7) at memory 40 in chunks of 2 with rho every 120, the ring filling
   and wrapping: against float64 under the same bars, a quarter of the
   problems past the wrap, and at a fixed rho for 100 iterations within
   twice the plain float32 version's error; the Gram area's and the
   ring's placement and the blocks an SM from the launcher against the
   rule's mirror; K3 and the wide K6 timed at memory 40 beside memory 4;
14. H. the linear-solver backends at the JAX bench's shapes:
   ``schur_block_tridiag`` on the vmap and fused tiers (the MPC at horizon
   64, B = 256, bench.py:508-518) beside K6 and the dense K3;
   ``schur_cholesky_blocked`` on one SQP problem with n = 4096
   (bench.py:455-470); ``cg`` and ``schur_cholesky_blocked`` on one dense
   QP with n = m = 4096 (bench.py:725-743's dense rows); ``kkt_ldlt`` and
   ``schur_cholesky_tri`` on the vmap one-shot QP (n = 32, m = 33,
   B = 1024): walls, host checks, solved fraction and the float64 OSQP
   test;
15. I. ``schur_arrow`` on the coupled MPC (bench.py:644-711: 48 agents of
   horizon 16, B = 64, n = 770, m = 1586, 100 iterations, adaptive rho) on
   the vmap and fused tiers beside the dense backend: walls, solved
   fraction, the float64 OSQP test of every SOLVED problem, the objective
   against dense's where both solved;
16. J. BlockSparse operands on ``cg`` (bench.py:722-811): the sparse twin of
   leg H's dense n = m = 4096 QP through ``qp_solve``, then sparse cg at
   n = m = 8192 (density 0.015 and 0.03) beside the blocked Cholesky;
17. K. the exponential chain (36 outers) and the ball-constrained
   Rosenbrock (300 outers) on the K1 tier, B = 1024, n = 32
   (bench.py:1123-1178, 1248-1306), each SOLVED problem's float64 KKT
   certificate at 1e-4 (>= 0.99 of them);
18. L. ``qp_solve_diff`` on the fused tier (B = 1024, n = m = 128,
   bench.py:1179-1247) and M. ``sqp_solve_diff`` on the K1 tier (the
   exponential chain, 24 outers, bench.py:1307-1382): forward and forward
   + backward walls (the adjoint is one K2 launch), finite gradients, and
   on 64 problems the adjoint through K2 and through K4 against each other
   and the plain route on the CPU;
19. N. the control arm end to end: ``qp_solve_batch(impl="kernel")`` with
   the declared stage block 18 (one wide K6 launch, every problem on its
   band rows, counted by the wrapper) at B = 1024: solves/s, solved >= 0.99, >= 0.99 of the problems passing the float64 OSQP test
   at 1e-4 with 10x slack, the device's idle share from one profiled run;
   P. the OSQP control class at 50 states, 25 inputs, horizon 10
   (declared stage block 75: internal block 152, the wide kernel past
   128; n = 750 padded to 760, m = 1,250) through
   ``qp_solve_batch(impl="kernel")`` at B = 128 with leg N's bars, the
   kernel's time per ADMM iteration and its bound, then the kernel against
   its plain version and float64 at B = 16 as leg N's row;
   O. the fused tier past D = 1024, ``qp_solve_batch(impl="fused")`` at
   n = m = 640, B = 256 (K5's wide variant): every SOLVED problem passes
   the float64 OSQP test;
   Q. the fused tier at the middle sizes, ``qp_solve_batch(impl="fused")``
   on random QPs n = m = 256 (D = 512, K5's cluster route) at B = 1024,
   solved >= 0.99, and on the control class at 12 states (n = 360, m =
   600, D = 960, the stream route) at B = 256 with leg N's settings on the
   dense route: solves/s, K5's launches by route, every SOLVED problem
   passing the float64 OSQP test at 10x the bars, the idle share;
20. the batch split, ``sharded_qp_solve_batch`` (K3) and
   ``sharded_sqp_solve_batch`` (K1) over ``make_mesh()``, equal to the
   unsharded calls; then every leg's seconds.

Each path run starts with every launch counter at 0 and asserts the
counts it reads right after.  The line before the last two is
``{"kernels": [...]}``; then the card's ``name, power.limit``; the last
line is ``{"ok": true, "device": ...}``.  The port's package is imported
from the directory of this script; no JAX is used.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "sqp_solver_tpu/ops/qp_kernel.py:1481"
K2_SOURCE = "sqp_solver_tpu/ops/qp_kernel.py:709"
K3_SOURCE = "sqp_solver_tpu/ops/qp_kernel.py:1622"
K4_SOURCE = "sqp_solver_tpu/ops/qp_kernel.py:535"
K5_SOURCE = "sqp_solver_tpu/ops/admm_kernel.py:132"
K6_SOURCE = "sqp_solver_tpu/ops/qp_kernel_btd.py:402"
K7_SOURCE = "sqp_solver_tpu/ops/qp_kernel_btd.py:569"
CU_SOURCE = "sqp_solver_tpu_torch/csrc/qp_kernel.cu"
K5_CU_SOURCE = "sqp_solver_tpu_torch/csrc/admm_kernel.cu"
BTD_CU_SOURCE = "sqp_solver_tpu_torch/csrc/qp_kernel_btd.cu"
BTD_WIDE_CU_SOURCE = "sqp_solver_tpu_torch/csrc/qp_kernel_btd_wide.cu"
TOL = 1e-4  # atol = rtol for float32 kernel vs float32 plain version
# atol = rtol where an adapted rho drives refactors: float32 kernel and
# float32 plain version each against the plain version in float64.  An
# adopted rho carries ~1e-3 relative float32 noise, and the trajectories
# part by up to ~1e-4 (the ADMM's own termination tolerance) before they
# stop at the same iteration
EPOCH_TOL = 5e-4
# the structured kernels on families with equality rows (the stage-wise
# MPC, the unicycle NLP's dynamics): float32 trajectories part from the
# float64 one (ROADMAP Queue 3), so the kernel must agree with float64
# (iteration and rho-update counts) on at least this share of what the
# plain float32 version agrees on
BTD_AGREE = 0.9
# the card's published peaks (H100 SXM data sheet): float32 outside the
# tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
COUNTERS = ("sqp_step_launches", "polish_kkt_launches", "qp_solve_launches",
            "spd_inverse_launches", "admm_chunk_launches", "qp_solve_btd_launches",
            "btd_step_launches", "qp_solve_btd_wide_launches", "btd_step_wide_launches")
CHUNK_ARGS = ("W", "P", "A", "qv", "scale1", "rhoip", "rhop", "lp", "up", "s", "yp")
LEAVES = ("P", "q", "A", "l", "u")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the float32 peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def counter_module(name: str):
    """The module whose launch counter ``name`` is."""
    from sqp_solver_tpu_torch.ops import admm_kernel, qp_kernel, qp_kernel_btd

    if name == "admm_chunk_launches":
        return admm_kernel
    return qp_kernel_btd if "btd" in name else qp_kernel


def reset_counts():
    for c in COUNTERS:
        setattr(counter_module(c), c, 0)


def read_counts() -> dict:
    return {c: getattr(counter_module(c), c) for c in COUNTERS}


def expect(**counts) -> dict:
    """Every counter at 0 but the ones given."""
    return dict.fromkeys(COUNTERS, 0) | counts


def main_qp_settings():
    from sqp_solver_tpu_torch.qp.types import QPSettings

    # the inner-QP settings of both benchmark configurations (bench.py:222-232)
    return QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                      check_termination=10, warm_start=True, adaptive_rho=True,
                      adaptive_rho_interval=50, schedule="fixed")


def bench_settings(n: int, qp_impl: str = "kernel"):
    """The benchmark configurations: bench.py:209-233 (n = 32) and
    bench.py:352-369 (n = 128), on the kernel or the fused QP tier."""
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    common = dict(eps_prim=2e-3, eps_dual=2e-3, termination="kkt", schedule="fixed",
                  qp_impl=qp_impl, polish=True, line_search_max_iter=5,
                  qp=main_qp_settings())
    if n == 32:
        return SQPSettings(max_iter=3, polish_passes=2, **common)
    return SQPSettings(max_iter=2, polish_passes=3, polish_sweeps=4, **common)


def to_device(arrs: dict, dev) -> dict:
    import torch

    return {k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool else torch.float32).to(dev)
            for k, v in arrs.items()}


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_close(label: str, a, b) -> float:
    import torch

    if not torch.allclose(a, b, atol=TOL, rtol=TOL):
        raise AssertionError(f"{label}: kernel and plain version differ by {max_err(a, b):.3e}")
    return max_err(a, b)


def step_operands(batch: int, n: int, dev) -> dict:
    """K1's operands at one of its paths' shapes (m = n + 1, no equality row)."""
    from sqp_solver_tpu_torch.testing import step_inputs

    return to_device(step_inputs(batch, n, n + 1, seed=n, dtype=np.float32,
                                 equality_row=False), dev)


def step_call(fn, t, settings=None, **kw):
    """K1 (or its plain version, or a launcher) on the operands ``t``, in
    the main path's inner-QP settings unless ``settings`` are given."""
    return fn(t["B"], t["J"], t["g"], t["l"], t["u"], t["s"], t["dgl"], t["reset"], t["upd"],
              t["active"], t["x"], t["z"], t["y"], settings or main_qp_settings(), **kw)


def polish_operands(batch: int, n: int, dev) -> dict:
    """K2's operands at one of its paths' shapes (m = n + 1, an indefinite H
    on problem 0)."""
    from sqp_solver_tpu_torch.testing import polish_inputs

    return to_device(polish_inputs(batch, n, n + 1, seed=n, dtype=np.float32), dev)


def polish_call(fn, t, sweeps: int, x0=None, **kw):
    """K2 (or its plain version, or a launcher) on the operands ``t``."""
    return fn(t["H"], t["J"], t["act"], t["r1"], t["b"], t["nu0"], delta=1e-2, sweeps=sweeps,
              x0=x0, **kw)


# the K1 / K2 shapes of the kernel phase: (kernel, batch, n, polish sweeps)
DENSE_SHAPES = (("K1", 4096, 32, 0), ("K1", 1024, 128, 0), ("K2", 4096, 32, 6),
                ("K2", 1024, 128, 4))


def dense_cases(dev) -> list:
    """Each K1 / K2 shape of the kernel phase with a launcher that takes a
    kernel library (None: the package's), for ``tools/kernel_ab.py`` and
    the phase split."""
    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    cases = []
    for kernel, batch, n, sweeps in DENSE_SHAPES:
        if kernel == "K1":
            t = step_operands(batch, n, dev)
            launch = (lambda lib, t=t: step_call(qk._sqp_step_launch, t, lib=lib))
            label = f"K1 n={n} B={batch}"
        else:
            t = polish_operands(batch, n, dev)
            launch = (lambda lib, t=t, sw=sweeps: polish_call(qk._polish_kkt_launch, t, sw,
                                                               lib=lib))
            label = f"K2 n={n} B={batch} {sweeps} sweeps"
        cases.append(dict(label=label, kernel=kernel, n=n, batch=batch, sweeps=sweeps,
                          reps=20 if n <= 32 else 8, launch=launch))
    return cases


# the K3 shapes of the kernel phase: (family, batch, n), and the K5 ones:
# (batch, n, m, seg), past D = 1024 the wide variant's
QP_SHAPES = (("random", 4096, 32), ("mpc", 4096, 16))
CHUNK_SHAPES = ((4096, 32, 33, 10), (4096, 32, 33, 25), (4096, 16, 32, 25), (1024, 128, 129, 10))
CHUNK_WIDE_SHAPES = ((256, 640, 640, 10), (64, 1024, 1024, 10))
# the middle sizes, D = 289-1024: random QPs n = m = 256 (D = 512) at the QP
# legs' chunks of 25 and at 10, and the OSQP control class's dense shape at
# 12 states (n = 360, m = 600, D = 960)
CHUNK_MID_SHAPES = ((1024, 256, 256, 25), (256, 360, 600, 25), (1024, 256, 256, 10))


def blocks_of(lib, kernel: str, batch: int, n: int, m: int) -> int:
    """Thread blocks of one launch of K1-K5: K3 and K4 put several problems
    in a block where their warp layouts apply (``qp_solve_problems_per_block``,
    ``spd_inverse_problems_per_block``; absent from a library built before
    that layout: one), and K5's wide variant a cluster of several blocks on
    one problem past D = 288 (``admm_chunk_layout``; in a library before the
    routes one up to D = 1024, and before the wide variant one at every D)."""
    per = 1
    if kernel == "K3" and hasattr(lib, "qp_solve_problems_per_block"):
        per = int(lib.qp_solve_problems_per_block(n, m))
    elif kernel == "K4" and hasattr(lib, "spd_inverse_problems_per_block"):
        per = int(lib.spd_inverse_problems_per_block(n))
    elif kernel == "K5" and n + m > 288 and (hasattr(lib, "admm_chunk_route_layout") or (
            n + m > 1024 and hasattr(lib, "admm_chunk_wide_layout"))):
        from sqp_solver_tpu_torch.ops import admm_kernel as ak

        return batch * ak.admm_chunk_layout(n, m, batch, lib=lib)["cluster"]
    return -(-batch // per)


# the K4 shapes of the kernel phase: (batch, n)
SPD_SHAPES = ((4096, 32), (1024, 128))


@functools.lru_cache(maxsize=None)
def spd_operands(batch: int, n: int, dev):
    """K4's operand at one shape (``testing.spd_inputs``: SPD, problem 0
    not), made once."""
    from sqp_solver_tpu_torch.testing import spd_inputs

    return to_device(spd_inputs(batch, n, seed=n, dtype=np.float32), dev)["M"]


def spd_cases(dev) -> list:
    """Each K4 shape of the kernel phase with a launcher that takes a kernel
    library, for ``tools/kernel_ab.py`` and the phase split."""
    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    cases = []
    for batch, n in SPD_SHAPES:
        M = spd_operands(batch, n, dev)
        cases.append(dict(label=f"K4 n={n} B={batch}", kernel="K4", n=n, batch=batch,
                          reps=20 if n <= 32 else 8,
                          launch=lambda lib, M=M: qk._spd_inverse_launch(M, lib=lib)))
    return cases


def qp_cases(dev) -> list:
    """Each K3 shape of the kernel phase (four rho epochs, as timed) with a
    launcher that takes a kernel library, for ``tools/kernel_ab.py`` and the
    phase split."""
    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    s = qp_bench_settings()
    cases = []
    for family, batch, n in QP_SHAPES:
        t = qp_operands(family, batch, n, dev)
        m = t["l"].shape[-1]
        cases.append(dict(label=f"K3 {family} n={n} m={m} B={batch}", kernel="K3", n=n, m=m,
                          batch=batch, reps=10,
                          launch=lambda lib, t=t: qp_raw(
                              lambda *a: qk._qp_solve_launch(*a, lib=lib), t, s)))
    return cases


@functools.lru_cache(maxsize=None)
def chunk_operands(batch: int, n: int, m: int, seg: int, dev) -> tuple:
    """K5's operands at one shape (``testing.admm_chunk_inputs``, made once:
    at n = 128 the host takes seconds to form W); past D = 288 formed on
    the card (:func:`chunk_operands_device`)."""
    from sqp_solver_tpu_torch.testing import admm_chunk_inputs

    if n + m > 288:
        return chunk_operands_device(batch, n, m, n + seg, dev)
    t = to_device(admm_chunk_inputs(batch, n, m, seed=n + seg, dtype=np.float32), dev)
    return tuple(t[k] for k in CHUNK_ARGS)


def chunk_operands_device(batch: int, n: int, m: int, seed: int, dev) -> tuple:
    """``testing.admm_chunk_inputs``'s operands (rho = 0.1, sigma = 1e-6, no
    equality or loose row) for the random QPs of ``models.mpc.random_qp_batch``
    drawn on the card (its device twin, ``random_qp_batch_device``), W
    formed in float64 there and every operand stored in float32: at
    D = 2048 the host would take minutes to draw and form them."""
    import torch

    from sqp_solver_tpu_torch.models.families import random_qp_batch_device

    gen = torch.Generator(device=dev).manual_seed(seed)
    qp = random_qp_batch_device(gen, batch, n, m, dtype=torch.float64)
    P, A = qp.P, qp.A
    rho, sigma = 0.1, 1e-6
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    Minv = torch.linalg.inv(P + sigma * eye + rho * A.mT @ A)
    G2 = Minv @ A.mT
    W = torch.cat([torch.cat([Minv, G2], dim=2), torch.cat([A @ Minv, A @ G2], dim=2)], dim=1)
    x = 0.1 * torch.randn((batch, n), generator=gen, dtype=torch.float64, device=dev)
    z = torch.clamp(0.1 * torch.randn((batch, m), generator=gen, dtype=torch.float64,
                                      device=dev), qp.l, qp.u)
    y = 0.1 * torch.randn((batch, m), generator=gen, dtype=torch.float64, device=dev)
    zn = torch.zeros((batch, n), dtype=torch.float64, device=dev)
    full = lambda v, k: torch.full((batch, k), v, dtype=torch.float64, device=dev)  # noqa: E731
    vecs = dict(
        qv=torch.cat([qp.q, full(0.0, m)], 1), scale1=torch.cat([full(sigma, n), full(rho, m)], 1),
        rhoip=torch.cat([zn, full(1.0 / rho, m)], 1), rhop=torch.cat([zn, full(rho, m)], 1),
        lp=torch.cat([full(-float("inf"), n), qp.l], 1),
        up=torch.cat([full(float("inf"), n), qp.u], 1), s=torch.cat([x, z], 1),
        yp=torch.cat([zn, y], 1))
    ops = dict(W=W, P=P, A=A, **vecs)
    return tuple(ops[k].float().contiguous() for k in CHUNK_ARGS)


def chunk_cases(dev, shapes=CHUNK_SHAPES) -> list:
    """Each K5 shape of ``shapes`` (``CHUNK_SHAPES``, the middle sizes'
    ``CHUNK_MID_SHAPES`` or the wide variant's ``CHUNK_WIDE_SHAPES``) with a
    launcher that takes a kernel library, on the operands of
    ``compare_chunk``."""
    from sqp_solver_tpu_torch.ops import admm_kernel as ak

    cases = []
    for batch, n, m, seg in shapes:
        args = chunk_operands(batch, n, m, seg, dev)
        cases.append(dict(label=f"K5 n={n} m={m} B={batch} seg={seg}", kernel="K5", n=n, m=m,
                          batch=batch, seg=seg, reps=20 if n <= 32 else 8 if n <= 128 else 4,
                          launch=lambda lib, args=args, seg=seg: ak._admm_chunk_launch(
                              *args, alpha=1.6, seg=seg, lib=lib)))
    return cases


def compare_step(batch: int, n: int, dev, reps: int) -> dict:
    """K1 against its plain version: do_bfgs on and off, then the SOC pair
    (want_minv, then minv_in with shifted bounds)."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    s = main_qp_settings()
    t = step_operands(batch, n, dev)

    errs = []
    cases = [("do_bfgs=True", t, dict(do_bfgs=True, want_minv=True)),
             ("do_bfgs=False", t, dict(do_bfgs=False, want_minv=True))]
    first = step_call(qk.sqp_step_kernel, t, want_minv=True)
    t2 = dict(t, B=first.B, l=(t["l"] - 0.01).contiguous(), u=(t["u"] - 0.01).contiguous(),
              x=first.p, z=first.z, y=first.y)
    cases.append(("minv_in", t2, dict(do_bfgs=False, rho_in=first.rho_factor,
                                      minv_in=first.minv)))
    for label, tt, kw in cases:
        ok = step_call(qk.sqp_step_kernel, tt, **kw)
        ref = step_call(qk.sqp_step_reference, tt, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ok.fail, ref.fail):
            raise AssertionError(f"K1 {label}: fail flags differ")
        same = ok.iter == ref.iter
        frac = float(same.float().mean())
        if frac < 0.99:
            raise AssertionError(f"K1 {label}: iteration counts agree on {frac:.4f} < 0.99")
        good = same & ~ref.fail
        for name in ("p", "z", "y", "B", "minv"):
            a, b = getattr(ok, name), getattr(ref, name)
            if a is not None:
                errs.append(check_close(f"K1 n={n} {label} {name}", a[good], b[good]))
        log(f"  K1 n={n} B={batch} {label}: iter agree {frac:.4f}, "
            f"max |kernel - plain| {max(errs):.3e}")
    ms = cuda_ms(lambda: step_call(qk.sqp_step_kernel, t), reps)
    plain_ms = cuda_ms(lambda: step_call(qk.sqp_step_reference, t), max(1, reps // 4))
    bound_ms, bound_by = step_bound(step_call(qk.sqp_step_kernel, t), s, batch, n)
    return dict(n=n, batch=batch, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def step_bound(out, s, batch: int, n: int):
    """(bound ms, by) of one K1 call (m = n + 1) that ran ``out``: BFGS
    (6 n^2), each factorization (Gram n^2 m, Cholesky + L^-1 + L^-T L^-1
    n^3), each ADMM iteration (2 n^2 + 4 m n), each chunk's residuals
    (2 n^2 + 4 m n) and the Anderson step."""
    m = n + 1
    seg = s.check_termination
    it = out.iter.double()
    flops = float((6 * n * n + out.n_factor.double() * (n * n * m + n ** 3)
                   + it * (2 * n * n + 4 * m * n) + (it / seg) * (2 * n * n + 4 * m * n)).sum())
    flops += aa_flops(out, s, n, m, 2 * n * n + 4 * m * n)
    return bound(flops, batch * (4 * (2 * n * n + m * n + 4 * n + 4 * m + n + 2 * m + 9) + 3))


def compare_polish(batch: int, n: int, sweeps: int, dev, reps: int) -> dict:
    """K2 against its plain version, with an indefinite H on problem 0."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    t = polish_operands(batch, n, dev)
    args = (t["H"], t["J"], t["act"], t["r1"], t["b"], t["nu0"])
    errs = []
    for x0 in (None, t["x0"]):
        ok = qk.polish_kkt_kernel(*args, delta=1e-2, sweeps=sweeps, x0=x0)
        ref = qk.polish_kkt_reference(*args, delta=1e-2, sweeps=sweeps, x0=x0)
        torch.cuda.synchronize()
        if not torch.equal(ok.fail, ref.fail) or not bool(ok.fail[0]) or bool(ok.fail[1:].any()):
            raise AssertionError("K2: fail flags wrong or differ from the plain version")
        good = ~ref.fail
        for name in ("x", "nu"):
            errs.append(check_close(f"K2 n={n} {name}", getattr(ok, name)[good],
                                    getattr(ref, name)[good]))
    log(f"  K2 n={n} B={batch}: fail flags agree, max |kernel - plain| {max(errs):.3e}")
    ms = cuda_ms(lambda: qk.polish_kkt_kernel(*args, delta=1e-2, sweeps=sweeps), reps)
    plain_ms = cuda_ms(lambda: qk.polish_kkt_reference(*args, delta=1e-2, sweeps=sweeps),
                       max(1, reps // 4))
    # Gram n^2 m, Cholesky + L^-1 2 n^3 / 3, each sweep 4 n^2 + 4 m n
    m = n + 1
    flops = batch * (n * n * m + 2 * n ** 3 / 3 + sweeps * (4 * n * n + 4 * m * n))
    nbytes = batch * (4 * (2 * n * n + m * n + 2 * n + 3 * m) + m + 1)
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(n=n, batch=batch, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def compare_polish_reuse(batch: int, n: int, sweeps: int, dev, reps: int) -> dict:
    """K2 with factor reuse (the JAX kernel's actt_prev / li_prev /
    fail_prev): a first pass, then a second on the same (H, J) with new
    right-hand sides and the mask of every tenth problem changed, so that
    ~90 % of the problems reuse the first pass's L^-1: the reuse kernel
    against the plain version with reuse, the clamped pivot of problem 0
    kept by fail_prev; on the first pass's inputs with every mask unchanged
    it equals the fresh kernel bit for bit.  Timed beside the fresh kernel
    on the second pass's inputs."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    t = polish_operands(batch, n, dev)
    args = (t["H"], t["J"], t["act"], t["r1"], t["b"], t["nu0"])
    first = qk.polish_kkt_kernel(*args, delta=1e-2, sweeps=sweeps)
    same = qk.polish_kkt_kernel(*args, delta=1e-2, sweeps=sweeps, act_prev=t["act"],
                                li_prev=first.li, fail_prev=first.fail)
    torch.cuda.synchronize()
    for name in ("x", "nu", "li"):
        if not torch.equal(getattr(first, name).view(torch.int32),
                           getattr(same, name).view(torch.int32)):
            raise AssertionError(f"K2 reuse on unchanged masks: {name} differs from the fresh "
                                 "kernel's")
    act_prev = t["act"].clone()
    act_prev[::10, 0] = ~act_prev[::10, 0]
    args2 = (t["H"], t["J"], t["act"], t["r1"] + 0.3, torch.where(t["act"], t["b"] - 0.2, 0.0),
             t["nu0"])
    kw = dict(delta=1e-2, sweeps=sweeps, act_prev=act_prev, li_prev=first.li,
              fail_prev=first.fail)
    ok = qk.polish_kkt_kernel(*args2, **kw)
    ref = qk.polish_kkt_reference(*args2, **kw)
    torch.cuda.synchronize()
    if not torch.equal(ok.fail, ref.fail) or not bool(ok.fail[0]) or bool(ok.fail[1:].any()):
        raise AssertionError("K2 reuse: fail flags wrong or differ from the plain version")
    good = ~ref.fail
    err = max(check_close(f"K2 reuse n={n} {name}", getattr(ok, name)[good],
                          getattr(ref, name)[good]) for name in ("x", "nu", "li"))
    changed = float((act_prev != t["act"]).any(dim=1).float().mean())
    ms = cuda_ms(lambda: qk.polish_kkt_kernel(*args2, **kw), reps)
    fresh_ms = cuda_ms(lambda: qk.polish_kkt_kernel(*args2, delta=1e-2, sweeps=sweeps), reps)
    plain_ms = cuda_ms(lambda: qk.polish_kkt_reference(*args2, **kw), max(1, reps // 4))
    log(f"  K2 reuse n={n} B={batch}: {changed:.3f} of the problems refactor; fail flags agree, "
        f"max |kernel - plain| {err:.3e}; unchanged masks equal the fresh kernel bit for bit; "
        f"{ms:.3f} ms against {fresh_ms:.3f} ms without reuse")
    # the factor (Gram n^2 m, Cholesky + L^-1 2 n^3 / 3) only where the mask
    # changed; each sweep 4 n^2 + 4 m n; li_prev and act_prev read too
    m = n + 1
    flops = batch * (changed * (n * n * m + 2 * n ** 3 / 3)
                     + sweeps * (4 * n * n + 4 * m * n))
    nbytes = batch * (4 * (3 * n * n + m * n + 2 * n + 3 * m) + 2 * m + 2)
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(n=n, batch=batch, reuse=True, refactored_share=changed, max_abs_err=err,
                ms=ms, fresh_ms=fresh_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_split(dev, libs: dict, card: str) -> list:
    """Cycles per block of each phase of K1-K5 at their shapes,
    from the builds with phase clocks (``libs``: one per source), one launch
    after a warm-up each; for the wide K5 also thread 0's cycles an
    iteration waiting on the ring, in dot products, and in the update and
    the cluster's exchange."""
    from sqp_solver_tpu_torch.tools.kernel_ab import SOURCES, clock_split, format_split

    rows = []
    for c in (dense_cases(dev) + qp_cases(dev) + spd_cases(dev) + chunk_cases(dev)
              + chunk_cases(dev, CHUNK_MID_SHAPES) + chunk_cases(dev, CHUNK_WIDE_SHAPES)):
        lib = libs[SOURCES[c["kernel"].lower()]]
        blocks = blocks_of(lib, c["kernel"], c["batch"], c["n"], c.get("m", c["n"]))
        cyc, _ = clock_split(lib, lambda: c["launch"](lib), blocks)
        row = dict(case=c["label"], blocks=blocks, cycles_per_block=cyc)
        per_iter = ""
        if c["kernel"] == "K5" and c["n"] + c["m"] > 288:  # thread 0's spans an iteration
            row["cycles_per_iteration"] = {k: cyc.get(k, 0.0) / c["seg"]
                                           for k in ("ring", "dot", "exchange", "iter")}
            per_iter = "; per iteration: " + ", ".join(
                f"{k} {v:.0f}" for k, v in row["cycles_per_iteration"].items())
        log(f"  {c['label']} ({blocks} blocks): {format_split(cyc)}{per_iter} [{card}]")
        rows.append(row)
    return rows


def wide_phase_split(lib, cases: list, card: str) -> list:
    """The wide K6/K7's phase split at its shapes (``cases``; past internal
    block 128 the compact route, whose Gram band and Thomas interleave a
    column block at a time: there the runner's of each block), from the
    build of ``csrc/qp_kernel_btd_wide.cu`` with phase clocks: cycles per
    block of each phase of one launch after a warm-up, and per ADMM
    iteration for the iterations' phases (A' w, M^-1 b, A v, the chunk
    stats) and the factor's (Gram band, Thomas)."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.tools.kernel_ab import clock_split, format_split

    rows = []
    for c in cases:
        blocks = c["batch"] * qb.cluster_size(c["n"], c["m"], c["bb"], c["batch"], lib=lib,
                                              nnz=btd_nnz(c))
        cyc, out = clock_split(lib, lambda: btd_launch(c["t"], c["settings"], c["check_infeas"],
                                                       lib=lib), blocks)
        it = float(out.iter.float().mean())
        per_iter = {k: v / it for k, v in cyc.items()
                    if k in ("atmv", "sweep", "amv", "stats", "gram", "thomas", "total")}
        log(f"  {c['label']} ({blocks} blocks, {it:.1f} ADMM iterations): {format_split(cyc)}; "
            "per iteration: " + ", ".join(f"{k} {v:.0f}" for k, v in per_iter.items())
            + f" cycles [{card}]")
        torch.cuda.synchronize()
        rows.append(dict(case=c["label"], blocks=blocks, mean_iter=it, cycles_per_block=cyc,
                         cycles_per_iteration=per_iter))
    return rows


def qp_bench_settings(**kw):
    """The QP legs' settings (bench.py:814-818 and :868-872): 200 ADMM
    iterations checked every 25, adaptive rho every 50 (4 rho epochs)."""
    from sqp_solver_tpu_torch.qp.types import QPSettings

    base = dict(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200, check_termination=25,
                adaptive_rho=True, adaptive_rho_interval=50, schedule="fixed")
    base.update(kw)
    return QPSettings(**base)


def qp_operands(family: str, batch: int, n: int, dev) -> dict:
    """float32 operands of one whole-QP call, cold-started."""
    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_qp_batch, random_qp_batch

    if family == "random":
        qp = random_qp_batch(batch, n, n + 1, seed=n, device=dev)
    else:
        qp = mpc_qp_batch(batch, horizon=n, seed=n, device=dev)
    t = {k: getattr(qp, k) for k in ("P", "q", "A", "l", "u")}
    m = t["l"].shape[-1]
    t.update(x=torch.zeros((batch, n), device=dev), z=torch.zeros((batch, m), device=dev),
             y=torch.zeros((batch, m), device=dev))
    return t


def qp_raw(fn, t, settings):
    return fn(*(t[k] for k in ("P", "A", "q", "l", "u", "x", "z", "y")), settings)


def compare_qp(family: str, batch: int, n: int, dev, reps: int) -> dict:
    """K3 against its plain version: one rho epoch kernel against plain at
    atol = rtol = 1e-4; four rho epochs, kernel and plain float32 each
    against plain float64 at ``EPOCH_TOL``.  Iterates are compared where the iteration
    counts agree, which they must on >= 99 % of problems."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    t = qp_operands(family, batch, n, dev)
    m = t["l"].shape[-1]
    one = qp_bench_settings(adaptive_rho=False)
    ok = qp_raw(qk._qp_solve_launch, t, one)
    ref = qp_raw(qk.qp_solve_reference, t, one)
    torch.cuda.synchronize()
    if not (torch.equal(ok.fail, ref.fail) and torch.equal(ok.infs, ref.infs)):
        raise AssertionError(f"K3 {family}: fail or certificate flags differ")
    same = ok.iter == ref.iter
    frac = float(same.float().mean())
    if frac < 0.99:
        raise AssertionError(f"K3 {family} one epoch: iteration counts agree on {frac:.4f}")
    errs = [check_close(f"K3 {family} {k}", getattr(ok, k)[same], getattr(ref, k)[same])
            for k in ("x", "z", "y")]
    s = qp_bench_settings()
    t64 = {k: v.double() for k, v in t.items()}
    p64 = qp_raw(qk.qp_solve_reference, t64, s)
    k32 = qp_raw(qk._qp_solve_launch, t, s)
    p32 = qp_raw(qk.qp_solve_reference, t, s)
    torch.cuda.synchronize()
    epoch_errs = {}
    for label, out in (("kernel", k32), ("plain", p32)):
        agree = (out.iter == p64.iter) & (out.rho_updates == p64.rho_updates)
        fr = float(agree.float().mean())
        if fr < 0.99:
            raise AssertionError(f"K3 {family} epochs: {label} agrees with f64 on {fr:.4f}")
        e = 0.0
        for k in ("x", "z", "y"):
            a, b = getattr(out, k)[agree].double(), getattr(p64, k)[agree]
            if not torch.allclose(a, b, atol=EPOCH_TOL, rtol=EPOCH_TOL):
                raise AssertionError(f"K3 {family} epochs: {label} {k} differs from f64 "
                                     f"by {max_err(a, b):.3e}")
            e = max(e, max_err(a, b))
        epoch_errs[label] = e
    log(f"  K3 {family} n={n} B={batch}: one epoch iter agree {frac:.4f}, max |kernel - "
        f"plain| {max(errs):.3e}; 4 epochs vs plain f64: kernel {epoch_errs['kernel']:.3e}, "
        f"plain f32 {epoch_errs['plain']:.3e}")
    ms = cuda_ms(lambda: qp_raw(qk._qp_solve_launch, t, s), reps)
    plain_ms = cuda_ms(lambda: qp_raw(qk.qp_solve_reference, t, s), max(1, reps // 4))
    per = qk.qp_solve_problems_per_block(n, m)
    layout = "warp" if per > 1 else "block"
    # the other layout at the same shape (the block layout: the earlier design)
    other = "block" if layout == "warp" else None
    other_ms = (cuda_ms(lambda: qp_raw(lambda *a: qk._qp_solve_launch(*a, layout=other), t, s),
                        reps) if other else None)
    log(f"  K3 {family} n={n} m={m}: {layout} layout ({per} problem(s) a block) {ms:.3f} ms"
        + (f", {other} layout {other_ms:.3f} ms" if other else ""))
    bound_ms, bound_by = qp_bound(k32, s, batch, n, m)
    return dict(family=family, n=n, m=m, batch=batch, max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                mean_iter=float(k32.iter.float().mean()), epochs_err=epoch_errs,
                layout=layout, other_layout=other, other_layout_ms=other_ms)


def qp_bound(out, s, batch: int, n: int, m: int):
    """(bound ms, by) of one K3 call that ran ``out``: per problem, each
    factorization (Gram n^2 m, Cholesky + L^-1 + L^-T L^-1 n^3), each ADMM
    iteration (2 n^2 + 4 m n), each chunk's residuals and certificate
    (2 x (2 n^2 + 4 m n)) and the Anderson step; P and A read once, q, l, u
    and the warm x, z, y read, x, z, y and the 8 stats written."""
    import torch

    it = out.iter.double()
    seg = s.check_termination
    interval = s.adaptive_rho_interval if s.adaptive_rho else s.max_iter
    epochs = torch.clamp_min(torch.ceil(it / interval), 1)
    nfact = torch.minimum(out.rho_updates.double(), epochs)
    flops = float((nfact * (n * n * m + n ** 3) + it * (2 * n * n + 4 * m * n)
                   + (it / seg) * 2 * (2 * n * n + 4 * m * n)).sum())
    flops += aa_flops(out, s, n, m, 2 * n * n + 4 * m * n)
    return bound(flops, batch * 4 * (n * n + m * n + 3 * (n + 2 * m) + 8))


def compare_certificates(dev) -> int:
    """A batch of feasible, primal- and dual-infeasible QPs (B = 256,
    n = 8): the kernel's statuses must equal the plain version's."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.testing import certificate_qp_inputs

    t = to_device(certificate_qp_inputs(256, 8, seed=1, dtype=np.float32), dev)
    s = qp_bench_settings()
    ok = qk.qp_status(qp_raw(qk._qp_solve_launch, t, s))
    ref = qk.qp_status(qp_raw(qk.qp_solve_reference, t, s))
    torch.cuda.synchronize()
    if not torch.equal(ok, ref):
        raise AssertionError(f"K3 certificates: statuses differ on "
                             f"{int((ok != ref).sum())} of 256 problems")
    counts = {int(v): int((ok == v).sum()) for v in torch.unique(ok)}
    if set(counts) != {0, 5, 6}:
        raise AssertionError(f"K3 certificates: statuses {counts}, expected solved, "
                             "primal and dual infeasible")
    log(f"  K3 certificate batch B=256 n=8: statuses equal, counts by status {counts}")
    return 0


def compare_spd(batch: int, n: int, dev, reps: int) -> dict:
    """K4 against its plain version on SPD matrices with a non-SPD
    problem 0 and, in its blocked layout (one problem a block), against the
    plain twin of that layout's blocked order (``_chol_inv_blocked``); then
    timed in turns with its library yardstick ``cholesky_ex`` +
    ``cholesky_inverse`` (kernel, library, library, kernel, three times),
    each reported as the median and the spread of its turns."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    M = spd_operands(batch, n, dev)
    Minv, fail = qk.spd_inverse_kernel(M)
    info = qk.spd_inverse_arm_info(n, device=dev.index)
    refs = {"plain": qk.spd_inverse_reference(M)}
    if info["problems_per_block"] == 1:
        refs["blocked twin"] = qk._chol_inv_blocked(M)
    torch.cuda.synchronize()
    errs = {}
    for label, (ref, rfail) in refs.items():
        if not torch.equal(fail, rfail) or not bool(fail[0]) or bool(fail[1:].any()):
            raise AssertionError(f"K4 n={n}: fail flags wrong or differ from the {label} version")
        errs[label] = check_close(f"K4 n={n} against the {label} version", Minv[1:], ref[1:])
    log(f"  K4 n={n} B={batch}: arm {info['arm']} ({info['problems_per_block']} problem(s), "
        f"{info['threads']} threads, {info['smem_bytes']} B of shared memory a block, "
        f"{info['registers']} registers and {info['local_bytes']} B of local memory a "
        f"thread, {info['blocks_per_sm']} blocks an SM); fail flags agree, max |kernel - "
        + ", ".join(f"{k}| {v:.3e}" for k, v in errs.items()))
    turns = {"kernel": [], "library": []}
    calls = {"kernel": lambda: qk.spd_inverse_kernel(M),
             "library": lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(M).L)}
    for _ in range(3):
        for who in ("kernel", "library", "library", "kernel"):
            turns[who].append(cuda_ms(calls[who], reps))
    ms, library_ms = (float(np.median(turns[k])) for k in ("kernel", "library"))
    log(f"  K4 n={n} B={batch} in turns: kernel {ms:.4f} ms (median; {min(turns['kernel']):.4f}"
        f"-{max(turns['kernel']):.4f}), library {library_ms:.4f} ms (median; "
        f"{min(turns['library']):.4f}-{max(turns['library']):.4f})")
    plain_ms = cuda_ms(lambda: qk.spd_inverse_reference(M), max(1, reps // 4))
    # Cholesky, L^-1 and L^-T L^-1, n^3 / 3 each; M's lower triangle read,
    # Minv and the fail byte written
    bound_ms, bound_by = bound(batch * n ** 3, batch * (4 * n * (n + 1) / 2 + 4 * n * n + 1))
    return dict(n=n, batch=batch, max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                kernel_turns=turns["kernel"], library_turns=turns["library"],
                library_spread=[min(turns["library"]), max(turns["library"])], layout=info)


def compare_chunk(batch: int, n: int, m: int, seg: int, dev, reps: int, lib=None) -> dict:
    """K5 against its plain version: one chunk of ``seg`` iterations and
    the stats, on the operands of random QPs (``chunk_operands``), with the
    bound (W read once) and the streaming floor (W every iteration) and the
    kernel's share of the floor; the route the layout rule takes, the rows
    of W on chip and the bytes of W read from device memory an iteration;
    past D = 288 also the layout (cluster, shared memory a block, stages,
    blocks an SM) and the time with each other route and cluster that fits
    forced (past D = 1024: clusters of 1, 2 and 4).  ``lib``: a kernel
    library other than the package's (a parent tree's: its own route)."""
    import torch

    from sqp_solver_tpu_torch.ops import admm_kernel as ak

    args = chunk_operands(batch, n, m, seg, dev)
    launch = lambda **kw: ak._admm_chunk_launch(*args, alpha=1.6, seg=seg, lib=lib, **kw)  # noqa
    ok = launch()
    ref = ak.admm_chunk_reference(*args, alpha=1.6, seg=seg)
    torch.cuda.synchronize()
    err = max(check_close(f"K5 n={n} seg={seg} {name}", a, b)
              for name, a, b in zip(("s", "yp", "stats"), ok, ref))
    D = n + m
    lay = ak.admm_chunk_layout(n, m, batch, device=dev, lib=lib)
    on_chip = lay["smem_rows"] + lay["register_rows"]
    log(f"  K5 n={n} m={m} B={batch} seg={seg}: max |kernel - plain| {err:.3e}; route "
        f"{lay['route']}, clusters of {lay['cluster']}; of the {D} rows of W {lay['smem_rows']} "
        f"in shared memory, {lay['register_rows']} in registers, {lay['device_rows']} read from "
        f"device memory every iteration ({lay['w_bytes_per_iteration']} bytes of W an iteration "
        f"a problem, {lay['w_bytes_per_iteration'] * batch} a launch)")
    ms = cuda_ms(launch, reps)
    plain_ms = cuda_ms(lambda: ak.admm_chunk_reference(*args, alpha=1.6, seg=seg),
                       max(1, reps // 4))
    # each iteration 2 D^2 (the matvec) + 10 D; the stats 2 n^2 + 4 m n.
    # W, P, A and eight (B, D) vectors read once, s, yp and the stats written
    flops = batch * (seg * (2 * D * D + 10 * D) + 2 * n * n + 4 * m * n)
    nbytes = 4 * batch * (D * D + n * n + m * n + 10 * D + 4)
    bound_ms, bound_by = bound(flops, nbytes)
    floor_bytes = 4 * batch * (seg * D * D + n * n + m * n + 10 * D + 4)
    floor_ms = floor_bytes / PEAK_BYTES_PER_S * 1e3
    row = dict(n=n, m=m, batch=batch, seg=seg, route=lay["route"], cluster=lay["cluster"],
               smem_rows=lay["smem_rows"], register_rows=lay["register_rows"],
               rows_on_chip=on_chip, device_rows=lay["device_rows"],
               w_bytes_per_iteration=lay["w_bytes_per_iteration"] * batch, max_abs_err=err,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               stream_floor_ms=floor_ms, stream_share=floor_ms / ms)
    more = ""
    if D > 288 and lay.get("smem_bytes"):
        forced = {}
        from sqp_solver_tpu_torch.ops import _build

        if hasattr(lib or _build.load(), "admm_chunk_route_layout"):
            choices = ([("stream", c) for c in (1, 2, 4)] if D > 1024 else
                       [("narrow", 0)] + [("cluster", c) for c in (2, 4, 8, 16)]
                       + [("stream", c) for c in (1, 2, 4, 8)])
            for route, c in choices:
                if (route, c) == (lay["route"], lay["cluster"]):
                    continue
                try:
                    ak.admm_chunk_layout(n, m, batch, route, c, device=dev, lib=lib)
                except ValueError:
                    continue  # does not fit
                forced[f"{route} {c}" if c else route] = cuda_ms(
                    lambda route=route, c=c: launch(route=route, cluster=c), reps)
        row.update(layout=lay, stream_gb_per_s=floor_bytes / ms / 1e6, forced_ms=forced)
        more = (f"; a block {lay['smem_bytes']} bytes of shared memory, {lay['rows_max']} rows "
                f"of W at most, {lay['stages']} stages of {lay['rows_stage']} rows, "
                f"{lay['blocks_per_sm']} block(s) an SM ({lay['resident']} resident); "
                f"{row['stream_gb_per_s']:.1f} GB/s of the floor's bytes; forced "
                + (", ".join(f"{k}: {v:.3f} ms" for k, v in forced.items()) or "-"))
    log(f"  K5 n={n} m={m} B={batch} seg={seg}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), streaming floor {floor_ms:.4f} ms (W every "
        f"iteration), {row['stream_share']:.3f} of it{more}")
    return row


def time_library_factor(batch: int, n: int, m: int, dev, reps: int) -> dict:
    """Milliseconds per call of the fused tier's factorization (the plain
    PyTorch ``schur_cholesky`` factor: ``cholesky_ex``, a triangular solve,
    one Newton-Schulz step and the matmuls that assemble W) on random QPs,
    from CUDA events; host launch time is inside it where the card waits."""
    from sqp_solver_tpu_torch.models.mpc import random_qp_batch
    from sqp_solver_tpu_torch.ops.linear_solver import _schur_factor

    qp = random_qp_batch(batch, n, m, seed=n, device=dev)
    rho_vec = qp.l.new_full((batch, m), 0.1)
    ms = cuda_ms(lambda: _schur_factor(qp.P, qp.A, 1e-6, rho_vec), reps)
    log(f"  library factor (schur_cholesky) n={n} m={m} B={batch}: {ms:.3f} ms per call")
    return dict(n=n, m=m, batch=batch, ms=ms)


def qp_cert64(qp, res, eps_abs: float, eps_rel: float, slack: float = 10.0):
    """Independent float64 check in numpy, no solver code: the share of
    problems passing the OSQP termination test (primal |Ax - proj(Ax)|,
    dual |Px + q + A'y|, against eps_abs + eps_rel scale) with ``slack``
    times the bars, and the KKT error max(stationarity, bound violation)
    per problem."""
    ok, kkt = qp_osqp64(qp, res, eps_abs, eps_rel, slack)
    return float(np.mean(ok)), kkt


def qp_osqp64(qp, res, eps_abs: float, eps_rel: float, slack: float = 10.0):
    """Per problem: (passes the float64 OSQP test at ``slack`` times the
    bars, KKT error), as :func:`qp_cert64`."""
    P, q, A, l, u = (getattr(qp, k).double().cpu().numpy() for k in ("P", "q", "A", "l", "u"))
    x = res.x.double().cpu().numpy()
    y = res.y.double().cpu().numpy()
    Ax = np.einsum("bmn,bn->bm", A, x)
    Px = np.einsum("bij,bj->bi", P, x)
    ATy = np.einsum("bmn,bm->bn", A, y)
    z = np.clip(Ax, l, u)
    inf = lambda v: np.abs(v).max(axis=1)  # noqa: E731
    rp = inf(Ax - z)
    rd = inf(Px + q + ATy)
    ok = (rp <= slack * (eps_abs + eps_rel * np.maximum(inf(Ax), inf(z)))) & (
        rd <= slack * (eps_abs + eps_rel * np.maximum(np.maximum(inf(Px), inf(ATy)), inf(q))))
    viol = np.maximum(np.maximum(l - Ax, Ax - u).max(axis=1), 0.0)
    return ok, np.maximum(rd, viol)


def host_checks() -> int:
    """The masked loops' host checks so far (``utils/host.py``)."""
    from sqp_solver_tpu_torch.utils import host

    return host.host_checks


def run_qp_one_shot(dev, card: str, impl: str = "kernel") -> dict:
    """qp_solve_batch(impl=...) on random QPs n = 32, m = 33, B = 4096:
    unpolished, polished (K2 route) and, on the kernel tier, polished
    through the K4 route, each run with the counters at 0.  The fused
    tier runs 200 iterations as 8 chunks of 25, one K5 launch each; the
    vmap tier's chunks are plain tensor code (no launch), its masked loops
    one host check a trip."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.mpc import random_qp_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp.polish import polish_qp
    from sqp_solver_tpu_torch.qp.types import QPStatus

    batch, n, m = 4096, 32, 33
    s = qp_bench_settings()
    sp = dataclasses.replace(s, polish=True)
    qp = random_qp_batch(batch, n, m, seed=0, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for seed in (101, 102):  # warm-up
        qp_solve_batch(random_qp_batch(batch, n, m, seed=seed, device=dev), sp, impl=impl)
    solve = {"kernel": dict(qp_solve_launches=1), "vmap": {},
             "fused": dict(admm_chunk_launches=-(-s.max_iter // s.check_termination))}[impl]
    runs = {}
    reset_counts()
    checks = host_checks()
    res, wall = timed(lambda: qp_solve_batch(qp, s, impl=impl))
    checks = host_checks() - checks
    runs["unpolished"] = (res, wall, read_counts(), solve)
    reset_counts()
    pol, wall_p = timed(lambda: qp_solve_batch(qp, sp, impl=impl))
    runs["polished_k2"] = (pol, wall_p, read_counts(),
                           dict(solve, polish_kkt_launches=s.polish_passes))
    if impl == "kernel":
        reset_counts()
        pol4, wall_4 = timed(lambda: polish_qp(qp, res, s, use_kernel=False))
        runs["polish_k4_route"] = (pol4, wall_4, read_counts(),
                                   dict(spd_inverse_launches=s.polish_passes))
    out = {}
    for label, (r, wall_r, counts, want) in runs.items():
        if counts != expect(**want):
            raise AssertionError(f"qp one-shot {impl} {label}: launches {counts}, "
                                 f"expected {want}")
        out[label] = dict(wall_ms=wall_r * 1e3, counts=counts)
    status = res.info.status.cpu().numpy()
    if res.x.shape != (batch, n) or not torch.isfinite(res.x).all():
        raise AssertionError("qp one-shot: solution has the wrong shape or is not finite")
    solved = float(np.mean(status == QPStatus.SOLVED))
    cert, kkt = qp_cert64(qp, res, s.eps_abs, s.eps_rel)
    p99 = {"unpolished": float(np.percentile(kkt, 99))}
    polished = [label for label in runs if label != "unpolished"]
    for label in polished:
        p99[label] = float(np.percentile(qp_cert64(qp, runs[label][0], s.eps_abs,
                                                   s.eps_rel)[1], 99))
    times = [wall] + [timed(lambda: qp_solve_batch(
        random_qp_batch(batch, n, m, seed=10 + r, device=dev), s, impl=impl))[1]
        for r in range(2)]
    t = min(times)
    log(f"  one-shot impl={impl} n={n} m={m} B={batch}: solved {solved:.4f}, f64 OSQP test "
        f"(10x) {cert:.4f}, mean iter {float(res.info.iter.float().mean()):.1f}, wall "
        f"{t * 1e3:.3f} ms ({batch / t:.1f} solves/s, min of {len(times)}), host checks "
        f"{checks} [{card}]")
    log(f"  f64 KKT error p99: unpolished {p99['unpolished']:.3e}, polished (K2) "
        f"{p99['polished_k2']:.3e} in {out['polished_k2']['wall_ms']:.3f} ms"
        + ("" if impl != "kernel" else f", K4 route {p99['polish_k4_route']:.3e} (polish "
           f"alone {out['polish_k4_route']['wall_ms']:.3f} ms)"))
    if solved < 0.99:
        raise AssertionError(f"qp one-shot {impl}: solved fraction {solved:.4f} < 0.99")
    if cert < 0.99:
        raise AssertionError(f"qp one-shot {impl}: f64 OSQP test passes on {cert:.4f} < 0.99")
    for label in polished:
        if not p99[label] <= p99["unpolished"]:
            raise AssertionError(f"qp one-shot {impl}: {label} KKT p99 {p99[label]:.3e} worse than "
                                 f"unpolished {p99['unpolished']:.3e}")
    return dict(runs=out, solved=solved, cert=cert, kkt_p99=p99, ms=t * 1e3,
                solves_per_s=batch / t, host_checks=checks)


def run_infeasible_fused(dev) -> dict:
    """Feasible, primal- and dual-infeasible QPs (B = 256, n = 8) through
    qp_solve_batch(impl="fused"), counters from 0: 8 K5 launches and the
    statuses of K3 on the same batch."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp.types import QuadraticProblem
    from sqp_solver_tpu_torch.testing import certificate_qp_inputs

    t = to_device(certificate_qp_inputs(256, 8, seed=1, dtype=np.float32), dev)
    s = qp_bench_settings()
    k3 = qk.qp_status(qp_raw(qk._qp_solve_launch, t, s))
    reset_counts()
    st = qp_solve_batch(QuadraticProblem(*(t[k] for k in LEAVES)), s, impl="fused").info.status
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expect(admm_chunk_launches=8):
        raise AssertionError(f"fused certificate batch: launches {counts}, expected 8 of K5")
    if not torch.equal(st, k3):
        raise AssertionError(f"fused certificate batch: statuses differ from K3's on "
                             f"{int((st != k3).sum())} of 256 problems")
    by_status = {int(v): int((st == v).sum()) for v in torch.unique(st)}
    log(f"  fused tier, certificate batch B=256 n=8: statuses equal K3's, counts by status "
        f"{by_status}")
    return dict(counts=counts, by_status=by_status)


def run_mpc_sequence(dev, card: str, impl: str = "kernel") -> dict:
    """qp_solve_sequence as in bench.py:854-901: K = 10 steps of a
    B = 4096 double-integrator fleet, n = 16, dt = 0.1, warm-started,
    through K3 (``impl="kernel"``, with the warm-start probe), the fused
    tier (8 K5 launches per step) or the vmap tier (no launch)."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_fleet
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp import qp_solve_sequence

    B, H, K = 4096, 16, 10
    make_qp, step = mpc_fleet(B, horizon=H, dt=0.1, device=dev)
    s = qp_bench_settings()

    def advance(st, r):
        nxt = step(st, r.x[:, 0])
        return nxt, ((r.info.status == 0).float().mean(), (nxt[:, 0] ** 2).mean().sqrt(),
                     r.info.iter.float().mean())

    def plants(seed):
        return torch.as_tensor(np.random.default_rng(seed).uniform(-1.0, 1.0, size=(B, 2)),
                               dtype=torch.float32).to(dev)

    def rollout(seed):
        x0 = plants(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, _, _ = qp_solve_sequence(make_qp, advance, x0, K, s, impl=impl)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    rollout(100)  # warm-up
    reset_counts()
    checks = host_checks()
    (solved, rms, iters), wall = rollout(0)
    checks = host_checks() - checks
    counts = read_counts()
    want = expect(**{"kernel": dict(qp_solve_launches=K), "vmap": {},
                     "fused": dict(admm_chunk_launches=8 * K)}[impl])
    if counts != want:
        raise AssertionError(f"sustained MPC {impl}: launches {counts}, expected {want}")
    solved, rms, iters = (v.cpu().numpy() for v in (solved, rms, iters))
    times = [wall] + [rollout(1 + r)[1] for r in range(2)]
    t = min(times)
    log(f"  sustained MPC impl={impl} K={K} x B={B} n={H}: solved per step min "
        f"{solved.min():.4f}, pos RMS {rms[0]:.4f} -> {rms[-1]:.4f}, mean iter step 1 "
        f"{iters[0]:.1f}, steps 2..K {iters[1:].mean():.1f}, wall {t * 1e3:.3f} ms -> "
        f"{K * B / t:.1f} solves/s sustained (min of {len(times)}), host checks {checks} "
        f"[{card}]")
    if solved.min() < 0.99:
        raise AssertionError(f"sustained MPC {impl}: a step solved {solved.min():.4f} < 0.99")
    if not rms[-1] < rms[0]:
        raise AssertionError(f"sustained MPC {impl}: the fleet's position RMS did not fall")
    out = dict(counts=counts, solved_min=float(solved.min()), rms_first=float(rms[0]),
               rms_last=float(rms[-1]), iter_first=float(iters[0]),
               iter_warm=float(iters[1:].mean()), ms=t * 1e3, solves_per_s=K * B / t,
               host_checks=checks)
    if impl != "kernel":
        return out
    # the sequence threads its warm starts: check_termination = 25 floors
    # the iteration counts, so they alone cannot tell a warm step from a
    # cold one.  A probe sequence stopped after 5 ADMM iterations per step
    # holds each warm step's residual against a cold solve of the same QP
    probe = dataclasses.replace(s, max_iter=5, check_termination=5, adaptive_rho=False)

    def worst(r):
        return torch.maximum(r.info.res_prim, r.info.res_dual).median()

    def probe_advance(st, r):
        cold = qp_solve_batch(make_qp(st), probe, impl="kernel")
        return step(st, r.x[:, 0]), worst(r) / worst(cold)

    ratio, _, _ = qp_solve_sequence(make_qp, probe_advance, plants(0), K, probe, impl="kernel")
    ratio = ratio.cpu().numpy()
    log(f"  after 5 ADMM iterations, median residual warm / cold of the same step: step 1 "
        f"{ratio[0]:.3f}, steps 2..K mean {ratio[1:].mean():.3f}")
    if not iters[1:].mean() < iters[0]:
        raise AssertionError("sustained MPC: warm steps are not cheaper than the cold one")
    if not ratio[1:].mean() < 0.5:
        raise AssertionError(f"sustained MPC: warm steps start no closer than cold ones "
                             f"(residual ratio {ratio[1:].mean():.3f})")
    return dict(out, probe_ratio_first=float(ratio[0]), probe_ratio_warm=float(ratio[1:].mean()))


def run_nlp_sequence(dev, card: str) -> dict:
    """sqp_solve_sequence as in bench.py:945-1029: one cold headline solve
    of the sphere-cap batch (n = 32, B = 4096), then 8 warm steps at one
    outer iteration each, every cap radius shrinking 2 % per step; the last
    step certified in float64 at 1e-4."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_problem
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu_torch.sqp import sqp_solve_sequence

    B, N, K = 4096, 32, 8
    settings = bench_settings(N)
    warm_settings = dataclasses.replace(settings, max_iter=1)

    def make(r):
        l = torch.zeros((B, N + 1), device=dev)
        u = torch.cat([(r ** 2)[:, None], torch.ones((B, N), device=dev)], dim=1)
        return sphere_cap_problem(l, u, r), torch.full((B, N), 0.25, device=dev)

    def advance(r, res):
        return 0.98 * r, (res.info.status == 0).float().mean()

    def serve(seed):
        rng = np.random.default_rng(seed)
        r0 = torch.as_tensor(rng.uniform(0.55 * np.sqrt(N), 0.9 * np.sqrt(N), B),
                             dtype=torch.float32).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob0, x00 = make(r0)
        res0 = sqp_solve_batch(prob0, x00, None, settings, impl="fused")
        fr, r_f, warm_f = sqp_solve_sequence(make, advance, 0.98 * r0, K, warm_settings,
                                             impl="fused", warm0=(res0.x, res0.lam))
        torch.cuda.synchronize()
        return fr, r_f, warm_f, time.perf_counter() - t0

    serve(100)  # warm-up
    reset_counts()
    fr, r_f, (x_f, lam_f), wall = serve(0)
    counts = read_counts()
    want = dict.fromkeys(COUNTERS, 0) | dict(
        sqp_step_launches=settings.max_iter + K,
        polish_kkt_launches=settings.polish_passes * (K + 1))
    if counts != want:
        raise AssertionError(f"sustained NLP: launches {counts}, expected {want}")
    fr = fr.cpu().numpy()
    r_last = r_f.double().cpu().numpy() / 0.98
    cert = sphere_cert_1e4(r_last ** 2, x_f.cpu().numpy(), lam_f.cpu().numpy())
    times = [wall] + [serve(1 + r)[3] for r in range(2)]
    t = min(times)
    log(f"  sustained NLP 1 cold + {K} warm x B={B} n={N}: warm solved min {fr.min():.4f}, "
        f"last-step f64 cert(1e-4) {cert:.4f}, wall {t * 1e3:.3f} ms -> "
        f"{(K + 1) * B / t:.1f} solves/s sustained (min of {len(times)}) [{card}]")
    if fr.min() < 0.99:
        raise AssertionError(f"sustained NLP: a warm step solved {fr.min():.4f} < 0.99")
    if cert < 0.99:
        raise AssertionError(f"sustained NLP: f64 certificate {cert:.4f} < 0.99")
    return dict(counts=counts, solved_min=float(fr.min()), cert=cert, ms=t * 1e3,
                solves_per_s=(K + 1) * B / t)


def sphere_cert_1e4(r2, x, lam) -> float:
    """Independent float64 KKT certificate of a sphere-cap batch with
    squared radii ``r2`` at the reference's own tolerance 1e-4 (the numpy
    twin of bench.py:155): exact stationarity -1 + 2 lam_0 x + lam_rest and
    feasibility of ||x||^2 <= r^2, 0 <= x <= 1, with no solver code on the
    path."""
    xs = np.asarray(x, np.float64)
    lm = np.asarray(lam, np.float64)
    st = -1.0 + 2.0 * lm[:, 0:1] * xs + lm[:, 1:]
    dr = np.abs(st).max(axis=1)
    pv = np.maximum(np.sum(xs * xs, axis=1) - r2, 0.0)
    pv = np.maximum(pv, np.maximum(xs - 1.0, -xs).max(axis=1))
    return float(np.mean((dr <= 1e-4) & (pv <= 1e-4)))


def btd_qp_settings(**kw):
    """The structured MPC cell's QP settings (bench.py:522-524): 100 ADMM
    iterations, checked every 25 with adaptive rho every 25 (the QPSettings
    defaults), block size 3."""
    from sqp_solver_tpu_torch.qp.types import QPSettings

    base = dict(adaptive_rho=True, max_iter=100, schedule="fixed",
                linear_solver="schur_block_tridiag", block_size=3)
    base.update(kw)
    return QPSettings(**base)


def btd_nlp_settings(qp_impl: str = "kernel_btd", soc: bool = False, block: int = 4):
    """The structured NLP cell (bench.py:586-595): 120 fixed outer
    iterations, polish 3 passes, inner QP 300 ADMM iterations, block 4
    (or ``block``: the unicycle's band at block 4 is block-tridiagonal at
    any multiple of it)."""
    from sqp_solver_tpu_torch.qp.types import QPSettings
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    return SQPSettings(
        max_iter=120, eps_prim=1e-4, eps_dual=1e-4, termination="kkt", schedule="fixed",
        polish=True, polish_passes=3, line_search_max_iter=16, qp_impl=qp_impl,
        second_order_correction=soc,
        qp=QPSettings(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=300,
                      check_termination=25, warm_start=True, adaptive_rho=True,
                      adaptive_rho_interval=50, block_size=block))


def btd_bound(out, settings, batch: int, n: int, m: int, bb: int, A=None):
    """(bound ms, by) of one structured solve from ``_qp_btd_call``'s
    cost estimate (sqp_solver_tpu/ops/qp_kernel_btd.py:371-376) at the
    iterations this call took: per problem 2 (4 n bb + 2 m n) flops per
    ADMM iteration and 2 n (2 m bb + 3 bb^2) per factorization (one per
    adopted rho, as K3's count); B (m n + 4 n bb) floats moved.  Given the
    operand ``A`` (B, m, n), the work this data needs instead: A's
    nonzeros (nnz a problem) in place of m n in the iterations' products
    and the floats moved, and its rows' own outer products (the sum over
    rows of nnz_r^2) in place of 2 m n bb in the Gram band."""
    import torch

    from sqp_solver_tpu_torch.ops.qp_kernel import _schedule

    seg, cpe, _ = _schedule(settings)
    it = out.iter.double()
    epochs = torch.clamp_min(torch.ceil(it / (cpe * seg)), 1)
    nfact = torch.minimum(out.rho_updates.double(), epochs) * (it > 0)
    if A is None:
        mv, gram, moved = float(m * n), float(2 * m * n * bb), float(batch * m * n)
    else:
        nz = (A != 0).double()
        mv, gram = nz.sum((1, 2)), (nz.sum(2) ** 2).sum(1)
        moved = float(mv.sum())
    flops = float((2 * (4 * n * bb + 2 * mv) * it
                   + 2 * (n * 3 * bb * bb + gram) * nfact).sum())
    per_iter = 2 * (4 * n * bb + 2 * (float(mv.mean()) if A is not None else mv))
    flops += aa_flops(out, settings, n, m, per_iter)
    return bound(flops, (moved + batch * 4 * n * bb) * 4)


def btd_bounds(out, c: dict) -> dict:
    """A structured row's bound on the data's work (A's nonzeros, the
    wide kernel's band rows) and on dense A, each with what bounds it."""
    args = (out, c["settings"], c["batch"], c["n"], c["m"], c["bb"])
    ms, by = btd_bound(*args, A=c["t"]["J"])
    dense_ms, dense_by = btd_bound(*args)
    return dict(bound_ms=ms, bound_by=by, bound_dense_ms=dense_ms, bound_dense_by=dense_by)


def aa_flops(out, settings, n: int, m: int, stats_flops: float) -> float:
    """The Anderson step's work over the chunks ``out`` ran (0 without it):
    a chunk's second residual evaluation (``stats_flops``), the 2 k dot
    products over D = n + 2 m of the kept Gram's new row and the
    right-hand side, and the candidate's k scaled differences
    (admm_core.cuh:aa_chunk_end)."""
    if settings.acceleration != "anderson":
        return 0.0
    k, D = settings.anderson_memory, n + 2 * m
    chunks = float(out.iter.double().sum()) / max(1, settings.check_termination)
    return chunks * (stats_flops + 2 * k * 2 * D + 2 * k * D)


def btd_raw(fn, t, settings, **kw):
    return fn(*(t[k] for k in ("pd", "pe", "J", "g", "l", "u", "x", "z", "y")), settings, **kw)


def btd_launch(t, settings, check_infeas: bool, cluster=None, lib=None):
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    kw = {} if cluster is None else dict(cluster=cluster)
    return btd_raw(qb._qp_btd_launch, t, settings, active=t.get("active"),
                   rho_in=t.get("rho_in"), check_infeas=check_infeas, name="chip_smoke",
                   lib=lib, **kw)


def btd_plain(t, settings, check_infeas: bool):
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    return btd_raw(qb.qp_btd_reference, t, settings, active=t.get("active"),
                   rho_in=t.get("rho_in"), check_infeas=check_infeas)


def btd_random_case(batch: int, T: int, bb: int, m: int, dev) -> dict:
    """Random block-tridiagonal QPs without equality rows
    (``testing.btd_qp_inputs``) in one rho epoch of 200 iterations."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_qp_inputs

    a = to_device(btd_qp_inputs(batch, T, bb, m, seed=T + m, dtype=np.float32), dev)
    pd, pe = qb.extract_band(a["P"], bb)
    t = dict(pd=pd, pe=pe, J=a["A"], g=a["q"], l=a["l"], u=a["u"], x=a["x"], z=a["z"],
             y=a["y"])
    one = qp_bench_settings(adaptive_rho=False, linear_solver="schur_block_tridiag",
                            block_size=bb)
    return dict(label=f"K6 random n={T * bb} B={batch}", family="random", t=t, settings=one,
                check_infeas=True, n=T * bb, m=m, bb=bb, batch=batch)


def btd_mpc_case(batch: int, dev, horizon: int = 64) -> dict:
    """The stage-wise MPC family at ``horizon`` (64: n = 192, m = 320) in
    the structured MPC cell's settings, cold-started."""
    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_qp_stagewise_batch
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    qp, b = mpc_qp_stagewise_batch(batch, horizon=horizon, seed=batch, device=dev)
    bb = qb.btd_internal_block(b)
    pd, pe = qb.extract_band(qp.P, bb)
    n, m = qp.q.shape[-1], qp.l.shape[-1]
    t = dict(pd=pd, pe=pe, J=qp.A, g=qp.q, l=qp.l, u=qp.u,
             x=torch.zeros((batch, n), device=dev), z=torch.zeros((batch, m), device=dev),
             y=torch.zeros((batch, m), device=dev))
    return dict(label=f"K6 MPC horizon {horizon} B={batch}", family="mpc", t=t,
                settings=btd_qp_settings(), check_infeas=True, n=n, m=m, bb=bb, batch=batch)


def btd_step_case(horizon: int, batch: int, dev) -> dict:
    """The first outer iteration's QPs of the unicycle NLP
    (``mpc_nlp_stagewise_batch``, the band reset to I, the Jacobian and
    gradient at the rollout start), a carried rho on every second problem
    and the last problem inactive, in the NLP cell's inner-QP settings."""
    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_nlp_stagewise_batch
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.sqp.common import batched_callables

    settings = btd_nlp_settings()
    problem, x0, b = mpc_nlp_stagewise_batch(batch, horizon=horizon, seed=horizon, device=dev)
    f_lin, _, _, c_lin, _ = batched_callables(problem, settings)
    _, g = f_lin(x0)
    c, J = c_lin(x0)
    n, m = x0.shape[-1], c.shape[-1]
    bb = qb.btd_internal_block(b)
    eye = torch.eye(bb, device=dev).expand(batch, n // bb, bb, bb).contiguous()
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    active[-1] = False
    rho_in = torch.where(torch.arange(batch, device=dev) % 2 == 1, 0.37, 0.0)
    t = dict(pd=eye, pe=torch.zeros_like(eye), J=J, g=g, l=(problem.l - c).contiguous(),
             u=(problem.u - c).contiguous(), x=torch.zeros_like(x0),
             z=torch.zeros_like(c), y=torch.zeros_like(c), active=active, rho_in=rho_in)
    return dict(label=f"K7 NLP step horizon {horizon} B={batch}",
                family=f"nlp step horizon {horizon}", t=t, settings=settings.qp,
                check_infeas=False, n=n, m=m, bb=bb, batch=batch)


def btd_cases(dev) -> list:
    """Every K6/K7 shape of the kernel phase, in its order."""
    return [btd_random_case(4096, 24, 8, 320, dev), btd_mpc_case(256, dev),
            btd_mpc_case(4096, dev), btd_step_case(32, 64, dev), btd_step_case(48, 64, dev)]


def control_settings():
    """The control arm's QP settings: OSQP's defaults (eps_abs = eps_rel =
    1e-3, alpha = 1.6, adaptive rho) with rho0 = 1 (from 0.1, 1.6 % of the
    arms stay unsolved in 4000 iterations in float32) and up to 8000
    iterations checked every 25, on the structured solver at the declared
    stage block nx + nu = 18."""
    from sqp_solver_tpu_torch.qp.types import QPSettings

    return QPSettings(alpha=1.6, eps_abs=1e-3, eps_rel=1e-3, max_iter=8000,
                      check_termination=25, adaptive_rho=True, adaptive_rho_interval=50,
                      rho=1.0, schedule="fixed", linear_solver="schur_block_tridiag",
                      block_size=18)


def control_qp(batch: int, seed: int, dev):
    """``testing.control_qp_inputs``: the OSQP control class's 6-DOF arm
    (12 states, 6 torques, horizon 20: n = 360, m = 600), float32 on the
    card."""
    from sqp_solver_tpu_torch.qp.types import QuadraticProblem
    from sqp_solver_tpu_torch.testing import control_qp_inputs

    t = to_device(control_qp_inputs(batch, seed=seed, dtype=np.float32), dev)
    return QuadraticProblem(**{k: t[k] for k in LEAVES})


def btd_control_case(batch: int, dev) -> dict:
    """The control arm at internal block 40 (n = 360 = 9 blocks), the wide
    kernel's main-path shape, cold-started, in the control leg's settings."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    qp = control_qp(batch, batch, dev)
    s = control_settings()
    bb = qb.btd_internal_block(s.block_size)
    pd, pe = qb.extract_band(qp.P, bb)
    n, m = qp.q.shape[-1], qp.l.shape[-1]
    t = dict(pd=pd, pe=pe, J=qp.A, g=qp.q, l=qp.l, u=qp.u,
             x=torch.zeros((batch, n), device=dev), z=torch.zeros((batch, m), device=dev),
             y=torch.zeros((batch, m), device=dev))
    return dict(label=f"K6 control arm B={batch}", family="control arm", t=t, settings=s,
                check_infeas=True, n=n, m=m, bb=bb, batch=batch, qp=qp)


def btd_wide_step_case(batch: int, T: int, bb: int, m: int, dev) -> dict:
    """K7's operands from ``testing.btd_step_inputs`` (random band QPs
    without equality rows, a carried rho on every second problem, the last
    problem inactive) in one rho epoch of 200 iterations."""
    from sqp_solver_tpu_torch.testing import btd_step_inputs

    t = to_device(btd_step_inputs(batch, T, bb, m, seed=T + m, dtype=np.float32), dev)
    one = qp_bench_settings(adaptive_rho=False, linear_solver="schur_block_tridiag",
                            block_size=bb)
    return dict(label=f"K7 random n={T * bb} B={batch}", family="random step", t=t,
                settings=one, check_infeas=False, n=T * bb, m=m, bb=bb, batch=batch)


def btd_mixed_case(batch: int, T: int, bb: int, m: int, dev) -> dict:
    """Random band QPs (``testing.btd_route_inputs``) in which every eighth
    problem has a row across three column blocks: those take the wide
    kernel's dense route, the others its band rows; one rho epoch of 200
    iterations."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_route_inputs

    dense = tuple(range(3, batch, 8))
    a = to_device(btd_route_inputs(batch, T, bb, m, seed=T + m, dense=dense,
                                   dtype=np.float32), dev)
    pd, pe = qb.extract_band(a["P"], bb)
    t = dict(pd=pd, pe=pe, J=a["A"], g=a["q"], l=a["l"], u=a["u"], x=a["x"], z=a["z"],
             y=a["y"])
    one = qp_bench_settings(adaptive_rho=False, linear_solver="schur_block_tridiag",
                            block_size=bb)
    return dict(label=f"K6 mixed routes n={T * bb} B={batch}", family="random, mixed routes",
                t=t, settings=one, check_infeas=True, n=T * bb, m=m, bb=bb, batch=batch,
                dense=len(dense))


def btd_wide_cases(dev) -> list:
    """The wide kernel's shapes of the kernel phase: K6 on the control arm
    (B = 1024), on random band QPs at internal blocks 64 and 128 and on a
    batch of both routes at 40 (n = 360, m = 600, B = 64), K7 on random band
    QPs at the structured NLP's block-64 shape (n = 128, m = 224, B = 64)
    and at 40 (n = 360, m = 600, B = 64)."""
    return [btd_control_case(1024, dev), btd_random_case(256, 4, 64, 384, dev),
            btd_random_case(128, 2, 128, 256, dev), btd_mixed_case(64, 9, 40, 600, dev),
            btd_wide_step_case(64, 2, 64, 224, dev), btd_wide_step_case(64, 9, 40, 600, dev)]


def control50_settings():
    """Leg P's QP settings: the control arm's (``control_settings``) at the
    declared stage block nx + nu = 75 of the OSQP control class at 50
    states (internal block 152)."""
    return dataclasses.replace(control_settings(), block_size=75)


def control50_qp(batch: int, seed: int, dev):
    """``testing.control_qp_inputs`` at 50 states and 25 inputs over 10 steps
    (the OSQP benchmark's Control class, nu = nx / 2, horizon 10: n = 750,
    m = 1,250), float32 on the card."""
    from sqp_solver_tpu_torch.qp.types import QuadraticProblem
    from sqp_solver_tpu_torch.testing import control_qp_inputs

    t = to_device(control_qp_inputs(batch, horizon=10, nx=50, nu=25, seed=seed,
                                    dtype=np.float32), dev)
    return QuadraticProblem(**{k: t[k] for k in LEAVES})


def control50_operands(qp, bb: int, dev):
    """The structured operands of ``qp`` as qp_solve_kernel_btd builds them:
    n padded to a multiple of ``bb`` with decoupled identity rows, the band
    of P, cold-started iterates; and the padded problem, whose float64 OSQP
    test is the original's (its padding entries of x, q, P x and A' y are
    0)."""
    from sqp_solver_tpu_torch.qp.types import QuadraticProblem

    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    batch, n0 = qp.q.shape
    n, m = -(-n0 // bb) * bb, qp.l.shape[-1]
    P = torch.nn.functional.pad(qp.P, (0, n - n0, 0, n - n0))
    P[:, n0:, n0:] = torch.eye(n - n0, device=dev)
    pd, pe = qb.extract_band(P, bb)
    J = torch.nn.functional.pad(qp.A, (0, n - n0)).contiguous()
    g = torch.nn.functional.pad(qp.q, (0, n - n0)).contiguous()
    t = dict(pd=pd, pe=pe, J=J, g=g, l=qp.l, u=qp.u, x=torch.zeros((batch, n), device=dev),
             z=torch.zeros((batch, m), device=dev), y=torch.zeros((batch, m), device=dev))
    return t, QuadraticProblem(P=P, q=g, A=J, l=qp.l, u=qp.u)


def btd_control50_case(batch: int, dev) -> dict:
    """The control class at 50 states (``control50_qp``) at internal block
    152 (n = 760 = 5 blocks), the wide kernel past 128, cold-started, in leg
    P's settings: K6's shape of leg P."""
    s = control50_settings()
    qp = control50_qp(batch, batch, dev)
    t, padded = control50_operands(qp, 152, dev)
    return dict(label=f"K6 control class nx=50 B={batch}", family="control nx=50", t=t,
                settings=s, check_infeas=True, n=t["g"].shape[-1], m=qp.l.shape[-1], bb=152,
                batch=batch, qp=padded)


def btd_control50_step_case(batch: int, dev) -> dict:
    """K7's entry at the control class's shape at 50 states (internal block
    152): its first QPs cold-started, a carried rho on every second problem
    and the last problem inactive, 200 iterations at leg P's bars."""
    import torch

    c = btd_control50_case(batch, dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    active[-1] = False
    rho_in = torch.where(torch.arange(batch, device=dev) % 2 == 1, 0.37, 0.0)
    return dict(c, label=f"K7 control class nx=50 B={batch}", family="control nx=50 step",
                t=dict(c["t"], active=active, rho_in=rho_in), check_infeas=False,
                settings=dataclasses.replace(c["settings"], max_iter=200))


def btd_past128_cases(dev) -> list:
    """The wide kernel past internal block 128, its compact route (A by its
    nonzeros, the layout rule's cluster): K6 on random band QPs at internal
    blocks 136 (n = 272, m = 160, B = 128) and 256 (n = 512, m = 200,
    B = 32; a matrix of the sweeps outgrows a block's shared memory, so
    they stay in the workspace), K7 at 136 (B = 64) and 256 (B = 32), and
    K7 at the control class's shape at 50 states (internal block 152,
    B = 16)."""
    return [btd_random_case(128, 2, 136, 160, dev), btd_random_case(32, 2, 256, 200, dev),
            btd_wide_step_case(64, 2, 136, 160, dev), btd_wide_step_case(32, 2, 256, 200, dev),
            btd_control50_step_case(16, dev)]


def compare_btd_past128(c: dict, reps: int) -> dict:
    """A wide case past internal block 128: on random bands
    (:func:`compare_btd_random`) the kernel against its plain version at
    atol = rtol = 1e-4 where the counts agree, then the kernel and the
    plain float32 version each against the plain float64 one
    (``against_f64``, one rho epoch, no equality rows); at the control
    class's shape (equality rows at rho_eq = 1e3 rho) the fixed-rho run of
    leg N (:func:`fixed_against_f64`): the kernel within twice the plain
    float32 version's distance from float64."""
    t, s, ci = c["t"], c["settings"], c["check_infeas"]
    if c["family"].startswith("control"):
        fixed = fixed_against_f64(c)
        ok = btd_launch(t, s, ci)
        ms = cuda_ms(lambda: btd_launch(t, s, ci), reps)
        plain_ms = cuda_ms(lambda: btd_plain(t, s, ci), 1)
        return btd_row(c, ok, max_abs_err=fixed["max_abs_err"], ms=ms, plain_ms=plain_ms,
                       **bounds_of(ok, c), fixed_rel_err=fixed)
    row = compare_btd_random(c, reps)
    r = against_f64(c["label"], t, s, ci)
    log(f"  {c['label']} bb={c['bb']}: vs plain f64, iter agree kernel {r['kernel']['agree']:.4f}"
        f" / plain f32 {r['plain']['agree']:.4f}, max diff kernel {r['kernel']['max_err']:.3e} /"
        f" plain f32 {r['plain']['max_err']:.3e}")
    return dict(row, agree_kernel=r["kernel"]["agree"], agree_plain=r["plain"]["agree"],
                f64_err=r["kernel"]["max_err"], f64_err_plain=r["plain"]["max_err"])


def btd_other(c: dict):
    """The block layout the launcher does not take at this case's shape (1
    or 2 blocks per problem for the narrow kernel at internal blocks 8 and
    16), or None where the kernel has one only (24, 32 and the wide
    kernel's cluster of two)."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    if qb.is_wide(c["bb"]) or c["bb"] > 16:
        return None
    return 3 - qb.cluster_size(c["n"], c["m"], c["bb"], c["batch"])


def btd_row(c: dict, out, **fields) -> dict:
    """One K6/K7 row of the kernel phase: the case's sizes, the variant the
    launcher took (``block``: one thread block per problem, ``cluster``:
    two), the rows of A on chip, the mean ADMM iterations of ``out`` and
    the time per iteration, and the other layout's error and time where
    ``fields`` has them, logged."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    n, m, bb, batch = c["n"], c["m"], c["bb"], c["batch"]
    nnz = btd_nnz(c)
    blocks = qb.cluster_size(n, m, bb, batch, nnz=nnz)
    rows = qb.smem_rows(n, m, bb, batch, nnz=nnz)
    mean_iter = float(out.iter.float().mean())
    per_iter = fields["ms"] / mean_iter if mean_iter > 0 else float("nan")
    other = ""
    if "other_ms" in fields:
        other = (f"; the other layout ({fields['other_variant']}) {fields['other_ms']:.3f} ms, "
                 f"max err {fields['other_max_abs_err']:.3e}")
    wide = {}
    where = f"{rows} of {m} rows of A on chip"
    if qb.is_wide(bb):
        lay = qb.wide_layout(n, m, bb, nnz=nnz)
        band = int(out.band.sum())
        wide = dict(layout=lay, routes=dict(band=band, dense=batch - band))
        where = (f"band rows: {band} of {batch} problems (dense route {batch - band}); a block "
                 f"{lay['smem_bytes'] / 1024:.1f} KB of shared memory holding "
                 f"{', '.join(lay['shared']) or 'none of its arrays'} (device memory: "
                 f"{', '.join(lay['device']) or '-'});"
                 f" {lay['iter_bytes']} bytes an iteration from device memory a problem")
    log(f"  {c['label']}: {variant_name(blocks)} per problem, {where}, {fields['ms']:.3f} ms "
        f"over a mean of {mean_iter:.1f} ADMM iterations: {per_iter * 1e3:.3f} us per "
        f"iteration{other}")
    return dict(family=c["family"], n=n, m=m, bb=bb, batch=batch,
                variant=variant_name(blocks), smem_rows=rows, library_ms=None,
                mean_iter=mean_iter, ms_per_iter=per_iter, **wide, **fields)


def btd_nnz(c: dict):
    """The nonzeros a block holds at each cluster (``qb.compact_nnz``) for a
    case past internal block 128, which the compact route's layout takes;
    None up to it."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    return qb.compact_nnz(c["t"]["J"], c["bb"]) if c["bb"] > qb.COMPACT_ABOVE else None


def variant_name(blocks: int) -> str:
    return {1: "block", 2: "cluster"}.get(blocks, f"cluster of {blocks}")


def btd_against_plain(label: str, ok, ref) -> float:
    """Flags equal, iteration counts agreeing on >= 0.99, x, z, y at
    atol = rtol = 1e-4 where they agree; returns the largest difference."""
    import torch

    if not (torch.equal(ok.fail, ref.fail) and torch.equal(ok.infs, ref.infs)):
        raise AssertionError(f"{label}: fail or certificate flags differ")
    same = ok.iter == ref.iter
    frac = float(same.float().mean())
    if frac < 0.99:
        raise AssertionError(f"{label}: iteration counts agree on {frac:.4f}")
    err = max(check_close(f"{label} {k}", getattr(ok, k)[same], getattr(ref, k)[same])
              for k in ("x", "z", "y"))
    log(f"  {label}: iter agree {frac:.4f}, max |kernel - plain| {err:.3e}")
    return err


def compare_btd_random(c: dict, reps: int) -> dict:
    """K6 against its plain version on the random band QPs of
    ``btd_random_case`` at atol = rtol = 1e-4 where the iteration counts
    agree, in the launcher's block layout and in the other one."""
    import torch

    t, one, ci = c["t"], c["settings"], c["check_infeas"]
    ok = btd_launch(t, one, ci)
    ref = btd_plain(t, one, ci)
    torch.cuda.synchronize()
    err = btd_against_plain(f"{c['label']} m={c['m']} bb={c['bb']}", ok, ref)
    other, extra = btd_other(c), {}
    if other is not None:
        alt = btd_launch(t, one, True, cluster=other)
        torch.cuda.synchronize()
        extra = dict(other_variant=variant_name(other),
                     other_max_abs_err=btd_against_plain(
                         f"{c['label']} ({variant_name(other)})", alt, ref),
                     other_ms=cuda_ms(lambda: btd_launch(t, one, True, cluster=other), reps))
    ms = cuda_ms(lambda: btd_launch(t, one, ci), reps)
    plain_ms = cuda_ms(lambda: btd_plain(t, one, ci), max(1, reps // 4))
    return btd_row(c, ok, max_abs_err=err, ms=ms, plain_ms=plain_ms, **bounds_of(ok, c),
                   **extra)


def bounds_of(out, c: dict) -> dict:
    """The bound fields of a K6/K7 row: the wide kernel's on A's nonzeros
    with dense A's beside it (``btd_bounds``), the narrow one's on dense A."""
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    if qb.is_wide(c["bb"]):
        return btd_bounds(out, c)
    ms, by = btd_bound(out, c["settings"], c["batch"], c["n"], c["m"], c["bb"])
    return dict(bound_ms=ms, bound_by=by)


def compare_btd_mixed(c: dict, reps: int) -> dict:
    """The wide kernel on a batch of both routes: the route of every
    problem equal to ``band_rows``' and to the plain wide route's, the
    wrapper's tally counting them, and each route against the plain
    version (``btd_against_plain``, per route)."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    t, one = c["t"], c["settings"]
    qb.reset_wide_route_counts()
    ok = btd_launch(t, one, True)
    ref = btd_raw(qb.qp_btd_reference, t, one, check_infeas=True, band=True)
    torch.cuda.synchronize()
    fits = qb.band_rows(t["J"], c["bb"])[2]
    counts = qb.wide_route_counts()
    if not (torch.equal(ok.band, fits) and torch.equal(ref.band, fits)):
        raise AssertionError(f"{c['label']}: the kernel's routes differ from band_rows'")
    if counts != dict(band=c["batch"] - c["dense"], dense=c["dense"]):
        raise AssertionError(f"{c['label']}: route tally {counts}")
    err = 0.0
    for name, sel in (("band", fits), ("dense", ~fits)):
        err = max(err, btd_against_plain(f"{c['label']} {name} route",
                                         ok._replace(**{k: getattr(ok, k)[sel] for k in (
                                             "x", "z", "y", "iter", "fail", "infs")}),
                                         ref._replace(**{k: getattr(ref, k)[sel] for k in (
                                             "x", "z", "y", "iter", "fail", "infs")})))
    log(f"  {c['label']}: routes {counts}, as band_rows and the plain wide route give them")
    ms = cuda_ms(lambda: btd_launch(t, one, True), reps)
    plain_ms = cuda_ms(lambda: btd_raw(qb.qp_btd_reference, t, one, check_infeas=True,
                                       band=True), max(1, reps // 4))
    return btd_row(c, ok, max_abs_err=err, ms=ms, plain_ms=plain_ms, **bounds_of(ok, c),
                   route_counts=counts)


def against_f64(label: str, t32, settings, check_infeas: bool, other=None) -> dict:
    """The kernel (in the launcher's layout and, with ``other``, in that
    one too) and the plain version in float32, each against the plain
    version in float64 at ``EPOCH_TOL`` on the problems that float64 solved
    and whose iteration and rho-update counts agree with it (an unsolved
    problem stops mid-flight, where float32 and float64 trajectories that
    parted are far apart); returns the agreement shares and the largest
    differences."""
    import torch

    t64 = {k: (v.double() if v.dtype == torch.float32 else v) for k, v in t32.items()}
    p64 = btd_plain(t64, settings, check_infeas)
    outs = [("kernel", btd_launch(t32, settings, check_infeas)),
            ("plain", btd_plain(t32, settings, check_infeas))]
    if other is not None:
        outs.append(("other", btd_launch(t32, settings, check_infeas, cluster=other)))
    torch.cuda.synchronize()
    res = {}
    for name, out in outs:
        agree = (out.iter == p64.iter) & (out.rho_updates == p64.rho_updates)
        cmp = agree & p64.done & ~p64.fail
        e = 0.0
        for k in ("x", "z", "y"):
            a, b = getattr(out, k)[cmp].double(), getattr(p64, k)[cmp]
            if not torch.allclose(a, b, atol=EPOCH_TOL, rtol=EPOCH_TOL):
                raise AssertionError(f"{label}: {name} {k} differs from f64 by "
                                     f"{max_err(a, b):.3e}")
            e = max(e, max_err(a, b))
        res[name] = dict(agree=float(agree.float().mean()), max_err=e,
                         status_agree=float((out.done == p64.done).float().mean()),
                         solved64=float((p64.done & ~p64.fail).float().mean()))
    for name in [k for k in ("kernel", "other") if k in res]:
        if res[name]["agree"] < BTD_AGREE * res["plain"]["agree"]:
            raise AssertionError(f"{label}: the {name} kernel agrees with f64 on "
                                 f"{res[name]['agree']:.4f}, the plain float32 version on "
                                 f"{res['plain']['agree']:.4f}")
    return dict(res, outs=dict(outs))


def fixed_against_f64(c: dict, iters: int = 200) -> dict:
    """Where float32 trajectories never meet float64's iteration counts
    (the control arm's 240 equality rows at rho_eq = 1e3 rho), the same
    launch at a fixed rho for ``iters`` iterations with no early exit: the
    kernel and the plain version in float32 each against the plain version
    in float64, as the largest per-problem error relative to 1 + the
    float64 iterate's largest entry over x, z, y; the kernel's must stay
    within twice the plain float32 version's (plus 1e-5).  Also returns
    the largest |kernel - plain float32| (``max_abs_err``)."""
    t32, ci = c["t"], c["check_infeas"]
    s = dataclasses.replace(c["settings"], adaptive_rho=False, max_iter=iters,
                            check_termination=iters, eps_abs=1e-12, eps_rel=1e-12)
    t64 = {k: (v.double() if v.is_floating_point() else v) for k, v in t32.items()}
    p64 = btd_plain(t64, s, ci)
    err, outs = {}, {}
    for name, out in (("kernel", btd_launch(t32, s, ci)), ("plain", btd_plain(t32, s, ci))):
        outs[name] = out
        err[name] = max(float(((getattr(out, k).double() - getattr(p64, k)).abs().amax(1)
                               / (1 + getattr(p64, k).abs().amax(1))).max())
                        for k in ("x", "z", "y"))
    log(f"  {c['label']}: {iters} iterations at a fixed rho, relative error against plain f64 "
        f"kernel {err['kernel']:.3e} / plain f32 {err['plain']:.3e}")
    if not err["kernel"] <= 2 * err["plain"] + 1e-5:
        raise AssertionError(f"{c['label']}: the kernel's error against f64 "
                             f"{err['kernel']:.3e} exceeds twice the plain f32 version's")
    err["max_abs_err"] = max(max_err(getattr(outs["kernel"], k), getattr(outs["plain"], k))
                             for k in ("x", "z", "y"))
    return err


def control_against_f64(c: dict) -> dict:
    """The control arm at its own settings: OSQP's 1e-3 bars let two float32
    runs that stop at the same iteration lie ~1e-3 apart, so the
    count-matched comparison at ``EPOCH_TOL`` does not apply.  Instead the
    kernel and the plain version in float32 must each solve >= 0.99 of the
    problems, >= 0.99 of the kernel's SOLVED problems must pass the float64
    OSQP test at the solver's own bars (1e-3, no slack), and, where both it
    and the plain version in float64 solved, the kernel's largest distance
    from the float64 x must stay within twice the plain float32 version's
    (plus 1e-5).  The fixed-rho run (:func:`fixed_against_f64`) holds the
    trajectories themselves."""
    import torch

    t32, s, ci = c["t"], c["settings"], c["check_infeas"]
    t64 = {k: (v.double() if v.is_floating_point() else v) for k, v in t32.items()}
    p64 = btd_plain(t64, s, ci)
    ker = btd_launch(t32, s, ci)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    p32 = btd_plain(t32, s, ci)
    end.record()
    torch.cuda.synchronize()
    res = {}
    for name, out in (("kernel", ker), ("plain", p32)):
        ok = out.done & ~out.fail & (out.infs == 0)
        both = ok & p64.done & ~p64.fail
        res[name] = dict(solved=float(ok.float().mean()),
                         x_err=max_err(out.x[both].double(), p64.x[both]))
    ok64, _ = qp_osqp64(c["qp"], ker, s.eps_abs, s.eps_rel, slack=1.0)
    solved = (ker.done & ~ker.fail).cpu().numpy()
    cert = float(np.mean(ok64[solved])) if solved.any() else 0.0
    log(f"  {c['label']}: solved kernel {res['kernel']['solved']:.4f} / plain f32 "
        f"{res['plain']['solved']:.4f}, the kernel's SOLVED passing the f64 OSQP test at "
        f"{s.eps_abs:g} {cert:.4f}; max |x - x_f64| where both solved kernel "
        f"{res['kernel']['x_err']:.3e} / plain f32 {res['plain']['x_err']:.3e}")
    if min(res["kernel"]["solved"], res["plain"]["solved"]) < 0.99 or cert < 0.99:
        raise AssertionError(f"{c['label']}: solved {res}, f64 test {cert:.4f}")
    if not res["kernel"]["x_err"] <= 2 * res["plain"]["x_err"] + 1e-5:
        raise AssertionError(f"{c['label']}: the kernel's x lies {res['kernel']['x_err']:.3e} "
                             "from f64's, over twice the plain f32 version's")
    return dict(res, cert64=cert, outs=dict(kernel=ker), plain_ms=start.elapsed_time(end))


def compare_btd_f64(c: dict, reps: int) -> dict:
    """K6 on the stage-wise MPC family (equality rows, rho epochs) or K7 on
    the unicycle NLP's first-iteration QPs: the kernel, in the launcher's
    block layout and in the other one, and the plain float32 version each
    against the plain float64 version (``against_f64``)."""
    t, s, other = c["t"], c["settings"], btd_other(c)
    r = against_f64(c["label"], t, s, c["check_infeas"], other)
    log(f"  {c['label']} n={c['n']} m={c['m']}: f64 solved {r['kernel']['solved64']:.4f}; vs "
        f"plain f64, iter and rho agree on kernel {r['kernel']['agree']:.4f} / plain f32 "
        f"{r['plain']['agree']:.4f}, max diff kernel {r['kernel']['max_err']:.3e} / plain f32 "
        f"{r['plain']['max_err']:.3e}")
    extra = {}
    if other is not None:
        log(f"  {c['label']} ({variant_name(other)}): vs plain f64, iter and rho agree on "
            f"{r['other']['agree']:.4f}, max diff {r['other']['max_err']:.3e}")
        extra = dict(other_variant=variant_name(other), other_max_abs_err=r["other"]["max_err"],
                     other_agree=r["other"]["agree"],
                     other_ms=cuda_ms(lambda: btd_launch(t, s, c["check_infeas"], cluster=other),
                                      reps))
    err = r["kernel"]["max_err"]
    ms = cuda_ms(lambda: btd_launch(t, s, c["check_infeas"]), reps)
    plain_ms = cuda_ms(lambda: btd_plain(t, s, c["check_infeas"]), max(1, reps // 4))
    return btd_row(c, r["outs"]["kernel"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   **bounds_of(r["outs"]["kernel"], c), agree_kernel=r["kernel"]["agree"],
                   agree_plain=r["plain"]["agree"], **extra)


def compare_control(c: dict, reps: int) -> dict:
    """The wide K6 on the control arm (:func:`control_against_f64`, then
    :func:`fixed_against_f64`), timed beside its plain version (the plain
    float32 call of :func:`control_against_f64`, CUDA events: one call of
    seconds needs no warm-up)."""
    t, s, ci = c["t"], c["settings"], c["check_infeas"]
    r = control_against_f64(c)
    fixed = fixed_against_f64(c)
    ms = cuda_ms(lambda: btd_launch(t, s, ci), reps)
    plain_ms = r["plain_ms"]
    return btd_row(c, r["outs"]["kernel"], max_abs_err=fixed["max_abs_err"], ms=ms,
                   plain_ms=plain_ms, **bounds_of(r["outs"]["kernel"], c),
                   solved=r["kernel"]["solved"], solved_plain=r["plain"]["solved"],
                   cert64=r["cert64"], x_err_f64=r["kernel"]["x_err"],
                   x_err_f64_plain=r["plain"]["x_err"], fixed_rel_err=fixed)


def run_btd_mpc(dev, card: str, batches=(256, 4096), horizon: int = 64,
                vmap_batch: int = 256) -> dict:
    """qp_solve_batch(impl="kernel") with linear_solver="schur_block_tridiag"
    (bench.py:500-557) on the stage-wise MPC family at horizon 64, B = 256
    and B = 4096, counters from 0 (one K6 launch per call), then the same
    problems through the dense K3 (one launch): statuses equal on >= 0.99,
    x within 2e-4 where both solved, every SOLVED problem passing the
    float64 OSQP test at 10x the bars.  At B = ``vmap_batch`` also the
    dense vmap tier (bench.py:512, no launch), whose SOLVED problems must
    pass the same test; no solved floor, as for the other tiers."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_qp_stagewise_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    from sqp_solver_tpu_torch.qp.types import QPSettings

    s = btd_qp_settings()
    dense = dataclasses.replace(s, linear_solver="schur_cholesky", block_size=0)
    # bench.py:512's "dense, vmap" row: the per-problem tier, early exit
    vmap = QPSettings(adaptive_rho=True, max_iter=100)

    def timed(batch, settings, seed, impl="kernel"):
        qp, _ = mpc_qp_stagewise_batch(batch, horizon=horizon, seed=seed, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = qp_solve_batch(qp, settings, impl=impl)
        torch.cuda.synchronize()
        return qp, res, time.perf_counter() - t0

    out, counts = {}, {}
    for batch in batches:
        runs = {}
        legs = [("btd", s, "kernel", expect(qp_solve_btd_launches=1)),
                ("dense", dense, "kernel", expect(qp_solve_launches=1))]
        if batch == vmap_batch:
            legs.append(("dense_vmap", vmap, "vmap", expect()))
        for label, settings, impl, want in legs:
            t_leg = time.perf_counter()
            timed(batch, settings, 100, impl)  # warm-up
            reset_counts()
            checks = host_checks()
            qp, res, wall = timed(batch, settings, 0, impl)
            checks = host_checks() - checks
            c = read_counts()
            if c != want:
                raise AssertionError(f"structured MPC B={batch} {label}: launches {c}, "
                                     f"expected {want}")
            times = [wall] + [timed(batch, settings, 10 + r, impl)[2] for r in range(2)]
            runs[label] = (qp, res, min(times), c, checks, time.perf_counter() - t_leg)
        qp, rb, tb, cb, _, _ = runs["btd"]
        _, rd, td, cd, _, _ = runs["dense"]
        sb, sd = rb.info.status, rd.info.status
        if rb.x.shape != (batch, 3 * horizon) or not torch.isfinite(rb.x).all():
            raise AssertionError("structured MPC: x has the wrong shape or is not finite")
        same = float((sb == sd).float().mean())
        if same < 0.99:
            raise AssertionError(f"structured MPC B={batch}: statuses equal K3's on {same:.4f}")
        both = (sb == 0) & (sd == 0)
        xerr = max_err(rb.x[both], rd.x[both])
        if xerr > 2e-4:
            raise AssertionError(f"structured MPC B={batch}: x differs from K3's by {xerr:.3e}")
        ok, _ = qp_osqp64(qp, rb, s.eps_abs, s.eps_rel)
        solved = (sb == 0).cpu().numpy()
        if not ok[solved].all():
            raise AssertionError(f"structured MPC B={batch}: {int((~ok[solved]).sum())} SOLVED "
                                 "problems fail the f64 OSQP test")
        frac_b, frac_d = float(np.mean(solved)), float((sd == 0).float().mean())
        log(f"  structured MPC horizon {horizon} n={3 * horizon} m={5 * horizon} B={batch}: K6 "
            f"{tb * 1e3:.3f} ms, dense K3 "
            f"{td * 1e3:.3f} ms (dense / structured {td / tb:.2f}x), solved {frac_b:.4f} / "
            f"{frac_d:.4f}, statuses equal {same:.4f}, max |x_K6 - x_K3| {xerr:.3e}, SOLVED "
            f"pass the f64 OSQP test (10x) [min of 3; {card}]")
        counts[f"btd_mpc_b{batch}"] = cb
        out[batch] = dict(ms=tb * 1e3, dense_ms=td * 1e3, ratio=td / tb, solved=frac_b,
                          dense_solved=frac_d, status_equal=same, x_err=xerr,
                          solves_per_s=batch / tb, dense_counts=cd)
        if "dense_vmap" in runs:
            _, rv, tv, cv, checks, seconds = runs["dense_vmap"]
            ok, _ = qp_osqp64(qp, rv, vmap.eps_abs, vmap.eps_rel)
            solved_v = (rv.info.status == 0).cpu().numpy()
            if not ok[solved_v].all():
                raise AssertionError(f"structured MPC B={batch} vmap: "
                                     f"{int((~ok[solved_v]).sum())} SOLVED problems fail the "
                                     "f64 OSQP test")
            log(f"  structured MPC B={batch}, walls side by side: K6 {tb * 1e3:.3f} ms, dense "
                f"K3 {td * 1e3:.3f} ms, dense vmap tier {tv * 1e3:.3f} ms ({batch / tv:.1f} "
                f"solves/s, solved {float(np.mean(solved_v)):.4f}, host checks {checks}, SOLVED "
                f"pass the f64 OSQP test) [min of 3; {card}]")
            out[batch].update(vmap_ms=tv * 1e3, vmap_solved=float(np.mean(solved_v)),
                              vmap_solves_per_s=batch / tv, vmap_host_checks=checks,
                              vmap_counts=cv, vmap_seconds=seconds)
    return dict(runs=out, counts=counts)


def run_btd_nlp(dev, card: str, B: int = 64, H: int = 32) -> dict:
    """sqp_solve_batch(impl="fused") with qp_impl="kernel_btd" (bench.py:
    559-642) on the unicycle family at horizon 32 (n = 128, m = 224),
    B = 64, counters from 0: 120 K7 and 3 K2 launches (240 K7 with the
    second-order correction; at block 64, two internal blocks, 120 of the
    wide kernel); the same instances through the dense kernel tier (120 K1,
    3 K2).  Certified in float64 with
    ``mpc_nlp_kkt_residuals`` at 1e-4; every SOLVED problem of the
    structured tier must certify."""
    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_nlp_kkt_residuals, mpc_nlp_stagewise_batch
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch

    def solve(settings, seed):
        problem, x0, _ = mpc_nlp_stagewise_batch(B, horizon=H, seed=seed, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sqp_solve_batch(problem, x0, None, settings, impl="fused")
        torch.cuda.synchronize()
        return problem, res, time.perf_counter() - t0

    out, counts = {}, {}
    for label, settings, want in (
        ("btd", btd_nlp_settings(), expect(btd_step_launches=120, polish_kkt_launches=3)),
        ("dense", btd_nlp_settings("kernel"), expect(sqp_step_launches=120,
                                                     polish_kkt_launches=3)),
        ("btd_soc", btd_nlp_settings(soc=True), expect(btd_step_launches=240,
                                                        polish_kkt_launches=3)),
        ("btd_wide", btd_nlp_settings(block=64), expect(btd_step_wide_launches=120,
                                                         polish_kkt_launches=3)),
    ):
        solve(settings, 100)  # warm-up
        reset_counts()
        problem, res, wall = solve(settings, 0)
        c = read_counts()
        if c != want:
            raise AssertionError(f"structured NLP {label}: launches {c}, expected {want}")
        times = [wall] + [solve(settings, 1 + r)[2] for r in range(2)]
        if res.x.shape != (B, 4 * H) or not torch.isfinite(res.x).all():
            raise AssertionError(f"structured NLP {label}: x has the wrong shape or is not "
                                 "finite")
        pv, dr = mpc_nlp_kkt_residuals(problem, res.x, res.lam, H)
        cert = (pv <= 1e-4) & (dr <= 1e-4)
        solved = (res.info.status == 0).cpu().numpy()
        if label != "dense" and not cert[solved].all():
            raise AssertionError(f"structured NLP {label}: {int((~cert[solved]).sum())} SOLVED "
                                 "problems fail the f64 certificate at 1e-4")
        t = min(times)
        log(f"  structured NLP {label} horizon {H} n={4 * H} m={7 * H} B={B}: solved "
            f"{solved.mean():.4f}, f64 cert(1e-4) {cert.mean():.4f}, SOLVED certified "
            f"{cert[solved].mean() if solved.any() else float('nan'):.4f}, wall {t * 1e3:.3f} "
            f"ms ({B / t:.1f} solves/s) [min of 3; {card}]")
        out[label] = dict(ms=t * 1e3, solved=float(solved.mean()), cert=float(cert.mean()),
                          solves_per_s=B / t, counts=c)
        if label != "dense":
            counts[f"btd_nlp_{label}" if label != "btd" else "btd_nlp"] = c
    ratio = out["dense"]["ms"] / out["btd"]["ms"]
    log(f"  structured NLP: dense kernel tier / structured tier wall {ratio:.2f}x")
    return dict(runs=out, counts=counts, ratio=ratio)


def run_control_arm(dev, card: str, batch: int = 1024) -> dict:
    """qp_solve_batch(impl="kernel") with the declared stage block 18 on
    the OSQP control class's 6-DOF arm (``control_qp``: n = 360, m = 600,
    240 dynamics equalities; internal block 40, the wide kernel), B = 1024,
    counters from 0 (one wide K6 launch): solved >= 0.99, and >= 0.99 of
    the problems pass the float64 OSQP test at 1e-4 with the legs' 10x
    slack (the solver's own bars, 1e-3), computed in numpy.  Wall min of 3
    after a warm-up, solves/s, and the device's idle share from one run
    under torch.profiler (``tools/trace_serving._trace``)."""
    import torch

    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.tools.trace_serving import _trace

    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    s = control_settings()
    qp = control_qp(batch, 11, dev)
    reset_counts()
    qb.reset_wide_route_counts()
    res = qp_solve_batch(qp, s, impl="kernel")
    torch.cuda.synchronize()
    c = read_counts()
    routes = qb.wide_route_counts()
    if c != expect(qp_solve_btd_wide_launches=1):
        raise AssertionError(f"control arm: launches {c}")
    if routes != dict(band=batch, dense=0):
        raise AssertionError(f"control arm: routes {routes}, expected every problem on the "
                             "band rows")
    lay = qb.wide_layout(360, 600, qb.btd_internal_block(s.block_size))
    log(f"  control arm: routes {routes}; the wide kernel in clusters of {lay['cluster']}, a "
        f"block {lay['smem_bytes'] / 1024:.1f} KB of shared memory, {lay['iter_bytes']} bytes "
        "an ADMM iteration from device memory")
    if res.x.shape != (batch, 360) or not torch.isfinite(res.x).all():
        raise AssertionError("control arm: x has the wrong shape or is not finite")
    solved = float((res.info.status == 0).float().mean())
    ok, kkt = qp_osqp64(qp, res, 1e-4, 1e-4)
    cert = float(np.mean(ok))
    it = res.info.iter.float()
    tr = _trace(lambda: qp_solve_batch(qp, s, impl="kernel"))
    wall = tr["wall_ms"] / 1e3
    log(f"  control arm n=360 m=600 B={batch}: solved {solved:.4f}, f64 OSQP test (1e-4, 10x) "
        f"{cert:.4f}, KKT error p50 {np.percentile(kkt, 50):.3e} p99 "
        f"{np.percentile(kkt, 99):.3e}, ADMM iterations mean {float(it.mean()):.1f} max "
        f"{int(it.max())}; wall {wall * 1e3:.3f} ms ({batch / wall:.1f} solves/s), device busy "
        f"{tr['device_busy_ms']:.3f} ms in the profiled run, idle share "
        f"{tr['idle_share_profiled']:.4f} of its wall ({tr['idle_share']:.4f} of the unprofiled "
        f"wall) [min of 3; {card}]")
    if solved < 0.99 or cert < 0.99:
        raise AssertionError(f"control arm: solved {solved:.4f}, f64 test {cert:.4f}")
    return dict(runs=dict(solved=solved, cert64=cert, kkt_p50=float(np.percentile(kkt, 50)),
                          kkt_p99=float(np.percentile(kkt, 99)), mean_iter=float(it.mean()),
                          max_iter=int(it.max()), ms=wall * 1e3, solves_per_s=batch / wall,
                          device_busy_ms=tr["device_busy_ms"], idle_share=tr["idle_share"],
                          idle_share_profiled=tr["idle_share_profiled"], counts=c,
                          routes=routes, layout=lay),
                counts=dict(control_arm=c))


def run_control50(dev, card: str, batch: int = 128, plain_batch: int = 16) -> dict:
    """Leg P: qp_solve_batch(impl="kernel") with the declared stage block 75
    on the OSQP control class at 50 states, 25 inputs and horizon 10
    (``control50_qp``: n = 750 padded to 760, m = 1,250, 500 dynamics
    equalities; internal block 152, the wide kernel past 128), B = 128,
    counters from 0 (one wide K6 launch, every problem on the band rows):
    solved >= 0.99, and >= 0.99 of the problems pass the float64 OSQP test
    at 1e-4 with the legs' 10x slack (the solver's own bars, 1e-3).  Then
    the kernel against its plain version and float64 at B = ``plain_batch``
    (``compare_control``: the plain versions at B = 128 take minutes).
    Wall min of 3 after a warm-up, solves/s, the device's idle share from
    one run under torch.profiler, the layout, the kernel's time per ADMM
    iteration (CUDA events over the mean and over the slowest problem's
    iterations) and its bound on A's nonzeros and on dense A."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.tools.trace_serving import _trace

    s = control50_settings()
    bb = qb.btd_internal_block(s.block_size)
    qp = control50_qp(batch, 50, dev)
    n0, m = qp.q.shape[-1], qp.l.shape[-1]
    n = -(-n0 // bb) * bb
    reset_counts()
    qb.reset_wide_route_counts()
    res = qp_solve_batch(qp, s, impl="kernel")
    torch.cuda.synchronize()
    c = read_counts()
    routes = qb.wide_route_counts()
    if c != expect(qp_solve_btd_wide_launches=1):
        raise AssertionError(f"control nx=50: launches {c}")
    if routes != dict(band=batch, dense=0):
        raise AssertionError(f"control nx=50: routes {routes}, expected every problem on the "
                             "band rows")
    if res.x.shape != (batch, n0) or not torch.isfinite(res.x).all():
        raise AssertionError("control nx=50: x has the wrong shape or is not finite")
    ops, _ = control50_operands(qp, bb, dev)
    nnz = qb.compact_nnz(ops["J"], bb)
    lay = qb.wide_layout(n, m, bb, nnz=nnz)
    log(f"  control nx=50: internal block {bb}, n = {n0} padded to {n}, m = {m}; routes "
        f"{routes}; the wide kernel in clusters of {lay['cluster']}, a block "
        f"{lay['smem_bytes'] / 1024:.1f} KB of shared memory holding "
        f"{', '.join(lay['shared']) or '-'} (the workspace: {', '.join(lay['device'])}, "
        f"{lay['workspace_floats'] * 4 / 2**20:.2f} MiB a block), {lay['iter_bytes']} bytes an "
        f"ADMM iteration from device memory a problem; A's nonzeros a block {nnz}")
    solved = float((res.info.status == 0).float().mean())
    ok, kkt = qp_osqp64(qp, res, 1e-4, 1e-4)
    cert = float(np.mean(ok))
    it = res.info.iter.float()
    launch = lambda: btd_launch(ops, s, True)  # noqa: E731
    ms = cuda_ms(launch, 2)
    ctx = dict(settings=s, batch=batch, n=n, m=m, bb=bb, t=ops)
    bounds = btd_bounds(res.info, ctx)
    tr = _trace(lambda: qp_solve_batch(qp, s, impl="kernel"))
    wall = tr["wall_ms"] / 1e3
    log(f"  control nx=50 n={n0} m={m} B={batch}: solved {solved:.4f}, f64 OSQP test (1e-4, 10x) "
        f"{cert:.4f}, KKT error p50 {np.percentile(kkt, 50):.3e} p99 "
        f"{np.percentile(kkt, 99):.3e}, ADMM iterations mean {float(it.mean()):.1f} max "
        f"{int(it.max())}; wall {wall * 1e3:.3f} ms ({batch / wall:.1f} solves/s), device busy "
        f"{tr['device_busy_ms']:.3f} ms in the profiled run, idle share "
        f"{tr['idle_share_profiled']:.4f} of its wall ({tr['idle_share']:.4f} of the unprofiled "
        f"wall); the kernel {ms:.3f} ms (CUDA events, mean of 2): "
        f"{ms * 1e3 / float(it.mean()):.3f} us per iteration of the mean, "
        f"{ms * 1e3 / float(it.max()):.3f} us per iteration of the slowest problem; bound "
        f"{bounds['bound_ms']:.4f} ms ({bounds['bound_by']}) on A's nonzeros, "
        f"{bounds['bound_dense_ms']:.4f} ms ({bounds['bound_dense_by']}) on dense A "
        f"[min of 3; {card}]")
    if solved < 0.99 or cert < 0.99:
        raise AssertionError(f"control nx=50: solved {solved:.4f}, f64 test {cert:.4f}")
    log(f"  control nx=50: the kernel against its plain version and float64 at "
        f"B={plain_batch}:")
    row = compare_control(btd_control50_case(plain_batch, dev), reps=2)
    return dict(runs=dict(solved=solved, cert64=cert, kkt_p50=float(np.percentile(kkt, 50)),
                          kkt_p99=float(np.percentile(kkt, 99)), mean_iter=float(it.mean()),
                          max_iter=int(it.max()), ms=wall * 1e3, solves_per_s=batch / wall,
                          kernel_ms=ms, us_per_iter_mean=ms * 1e3 / float(it.mean()),
                          us_per_iter_max=ms * 1e3 / float(it.max()), **bounds,
                          device_busy_ms=tr["device_busy_ms"], idle_share=tr["idle_share"],
                          idle_share_profiled=tr["idle_share_profiled"], counts=c,
                          routes=routes, layout=lay, batch=batch, plain_batch=plain_batch,
                          nnz=nnz),
                row=row, counts=dict(control50=c))


def run_fused_wide(dev, card: str, batch: int = 256, n: int = 640) -> dict:
    """qp_solve_batch(impl="fused") past D = 1024: random QPs n = m = 640
    (D = 1280), B = 256, drawn on the card, at the QP legs' settings
    (up to 8 chunks of 25), counters from 0 (K5 launches only, the wide
    variant):
    every SOLVED problem passes the float64 OSQP test at 10x the bars."""
    import torch

    from sqp_solver_tpu_torch.models.families import random_qp_batch_device
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    s = qp_bench_settings()
    qp = random_qp_batch_device(torch.Generator(device=dev).manual_seed(n), batch, n, n)
    qp_solve_batch(qp, s, impl="fused")  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = qp_solve_batch(qp, s, impl="fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts()
    if c["admm_chunk_launches"] < 1 or c != expect(admm_chunk_launches=c["admm_chunk_launches"]):
        raise AssertionError(f"fused tier D={2 * n}: launches {c}")
    ok, _ = qp_osqp64(qp, res, s.eps_abs, s.eps_rel)
    solved = (res.info.status == 0).cpu().numpy()
    if not np.isfinite(res.x.cpu().numpy()).all() or not ok[solved].all():
        raise AssertionError(f"fused tier D={2 * n}: SOLVED problems fail the f64 OSQP test")
    log(f"  fused tier n=m={n} (D={2 * n}) B={batch}: solved {solved.mean():.4f}, SOLVED pass "
        f"the f64 OSQP test (10x), wall {wall * 1e3:.3f} ms ({batch / wall:.1f} solves/s) "
        f"[{card}]")
    return dict(runs=dict(solved=float(solved.mean()), ms=wall * 1e3,
                          solves_per_s=batch / wall, counts=c),
                counts={f"qp_fused_d{2 * n}": c})


def fused_dense_leg(label: str, qp, settings, card: str, min_solved: float = 0.0) -> dict:
    """qp_solve_batch(impl="fused") on ``qp``, counters from 0 for one run
    (K5 launches only, by the route each took): solves/s from the wall's
    min of 3 after a warm-up and the device's idle share from one run
    under torch.profiler (``tools/trace_serving._trace``), the solved
    share (at least ``min_solved``), and every SOLVED problem passing the
    float64 OSQP test at 10x the bars."""
    import torch

    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.tools.trace_serving import _trace

    batch = qp.q.shape[0]
    qp_solve_batch(qp, settings, impl="fused")  # warm-up
    reset_counts()
    ak.reset_route_counts()
    res = qp_solve_batch(qp, settings, impl="fused")
    torch.cuda.synchronize()
    c = read_counts()
    routes = ak.route_counts()
    if c["admm_chunk_launches"] < 1 or c != expect(admm_chunk_launches=c["admm_chunk_launches"]):
        raise AssertionError(f"{label}: launches {c}")
    if sum(routes.values()) != c["admm_chunk_launches"]:
        raise AssertionError(f"{label}: routes {routes} against {c['admm_chunk_launches']} launches")
    ok, kkt = qp_osqp64(qp, res, settings.eps_abs, settings.eps_rel)
    solved = (res.info.status == 0).cpu().numpy()
    if not np.isfinite(res.x.cpu().numpy()).all() or not ok[solved].all():
        raise AssertionError(f"{label}: SOLVED problems fail the f64 OSQP test")
    if solved.mean() < min_solved:
        raise AssertionError(f"{label}: solved {solved.mean():.4f} < {min_solved}")
    tr = _trace(lambda: qp_solve_batch(qp, settings, impl="fused"))
    wall = tr["wall_ms"] / 1e3
    it = res.info.iter.float()
    log(f"  {label} B={batch}: solved {solved.mean():.4f}, every SOLVED passes the f64 OSQP test "
        f"(10x the bars: {float(ok[solved].mean()) if solved.any() else 1.0:.4f} of them), ADMM "
        f"iterations mean {float(it.mean()):.1f} max {int(it.max())}; K5 launches "
        f"{c['admm_chunk_launches']} by route {routes}; wall {wall * 1e3:.3f} ms "
        f"({batch / wall:.1f} solves/s, min of 3), K5 {tr['k5_ms']:.3f} ms of device time in "
        f"the profiled run, idle share {tr['idle_share']:.4f} of the wall "
        f"({tr['idle_share_profiled']:.4f} profiled) [{card}]")
    return dict(solved=float(solved.mean()), cert64_solved=float(ok[solved].mean()) if
                solved.any() else 1.0, mean_iter=float(it.mean()), max_iter=int(it.max()),
                ms=wall * 1e3, solves_per_s=batch / wall, k5_ms=tr["k5_ms"],
                device_busy_ms=tr["device_busy_ms"], idle_share=tr["idle_share"],
                idle_share_profiled=tr["idle_share_profiled"], counts=c, routes=routes,
                batch=batch)


def run_fused_mid(dev, card: str) -> dict:
    """Leg Q: the fused tier at the middle sizes, where K5 takes the cluster
    or stream route (D = 289-1024): random QPs n = m = 256 (D = 512,
    ``random_qp_batch_device``) at B = 1024 at the QP legs' settings
    (chunks of 25), solved >= 0.99; and the OSQP control class at 12 states
    (``control_qp``, leg N's problems: n = 360, m = 600, D = 960) at B = 256
    at leg N's settings on the dense route, as a user solves it without
    declaring stages (``schur_cholesky``)."""
    import torch

    from sqp_solver_tpu_torch.models.families import random_qp_batch_device

    qp = random_qp_batch_device(torch.Generator(device=dev).manual_seed(256), 1024, 256, 256)
    rand = fused_dense_leg("fused tier random n=m=256 (D=512)", qp, qp_bench_settings(), card,
                           min_solved=0.99)
    dense = dataclasses.replace(control_settings(), linear_solver="schur_cholesky",
                                block_size=0)
    ctrl = fused_dense_leg("fused tier control class nx=12 n=360 m=600 (D=960)",
                           control_qp(256, 12, dev), dense, card)
    return dict(runs=dict(random_d512=rand, control_d960=ctrl),
                counts=dict(qp_fused_d512=rand["counts"], qp_fused_control_d960=ctrl["counts"]))


# the families leg (bench.py:1066-1072): each OSQP class's device twin and
# its published sizes
FAMILY_ROWS = (("random", "random_qp_batch_device", dict(n=32, m=48)),
               ("lasso", "lasso_qp_batch_device", dict(n_features=8, n_samples=16)),
               ("huber", "huber_qp_batch_device", dict(n_features=8, n_samples=16)),
               ("svm", "svm_qp_batch_device", dict(n_features=8, n_samples=16)),
               ("portfolio", "portfolio_qp_batch_device", dict(n_assets=16, n_factors=4)))


def family_settings():
    """The families leg's one untuned configuration (bench.py:1061-1065):
    Ruiz scaling 10, 300 ADMM iterations checked every 25, adaptive rho
    every 50, fixed schedule, polish."""
    from sqp_solver_tpu_torch.qp.types import QPSettings

    return QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=300,
                      check_termination=25, adaptive_rho=True, adaptive_rho_interval=50,
                      polish=True, scaling=10, schedule="fixed")


def run_families(dev, card: str, batch: int = 1024) -> dict:
    """The five OSQP classes at B = 1024, drawn on the card, through
    qp_solve_batch(impl="kernel") under scaling (one K3 launch, K2 per
    polish pass), the random class also through impl="vmap" (K2 only) and
    "fused" (12 K5 launches): per class the solved share and the float64
    OSQP test at 10x the bars against the unscaled problem, >= 0.99."""
    import torch

    from sqp_solver_tpu_torch.models import families
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    s = family_settings()
    wants = {"kernel": expect(qp_solve_launches=1, polish_kkt_launches=s.polish_passes),
             "vmap": expect(polish_kkt_launches=s.polish_passes),
             "fused": expect(admm_chunk_launches=-(-s.max_iter // s.check_termination),
                             polish_kkt_launches=s.polish_passes)}
    out, counts = {}, {}
    for cls, fn_name, kw in FAMILY_ROWS:
        make = getattr(families, fn_name)
        for impl in (("kernel", "vmap", "fused") if cls == "random" else ("kernel",)):
            def solve(seed):
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed)
                qp = make(gen, batch, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = qp_solve_batch(qp, s, impl=impl)
                torch.cuda.synchronize()
                return qp, res, time.perf_counter() - t0

            solve(100)  # warm-up
            reset_counts()
            checks = host_checks()
            qp, res, wall = solve(0)
            checks = host_checks() - checks
            c = read_counts()
            if c != wants[impl]:
                raise AssertionError(f"family {cls} {impl}: launches {c}, expected "
                                     f"{wants[impl]}")
            if not torch.isfinite(res.x).all():
                raise AssertionError(f"family {cls} {impl}: x is not finite")
            times = [wall] + [solve(10 + r)[2] for r in range(2)]
            t = min(times)
            solved = float((res.info.status == 0).float().mean())
            ok, _ = qp_osqp64(qp, res, s.eps_abs, s.eps_rel)
            cert = float(np.mean(ok))
            key = f"{cls}_{impl}"
            log(f"  family {cls} {tuple(kw.values())} impl={impl} B={batch}: solved "
                f"{solved:.4f}, f64 OSQP test (10x, unscaled problem) {cert:.4f}, wall "
                f"{t * 1e3:.3f} ms ({batch / t:.1f} solves/s, min of 3), host checks {checks} "
                f"[{card}]")
            if cert < 0.99:
                raise AssertionError(f"family {cls} {impl}: f64 OSQP test passes on "
                                     f"{cert:.4f} < 0.99")
            counts[f"family_{key}"] = c
            out[key] = dict(solved=solved, cert=cert, ms=t * 1e3, solves_per_s=batch / t,
                            host_checks=checks)
    return dict(runs=out, counts=counts)


def run_main_path(configs, dev, card: str, qp_impl: str = "kernel", impl: str = "fused",
                  scaling: int = 0, qp_kw=None) -> dict:
    """Both configurations end to end on the kernel (K1) or the fused (K5)
    QP tier, or with ``impl="vmap"`` on the per-problem tier, each run
    with the counters from 0 and its launches asserted: K1 once per outer
    iteration, or K5 once per chunk of each outer iteration's QP, or none
    (the vmap tier's chunks are plain tensor code); K2 once per polish
    pass.  ``scaling`` sets the inner QP's Ruiz sweeps (on the kernel tier
    K1 then runs with ``do_bfgs=False``); ``qp_kw`` other inner-QP
    settings (``acceleration``)."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch, sphere_cap_solution
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu_torch.sqp.types import SQPStatus

    label = f"impl={impl}" if impl == "vmap" else f"qp_impl={qp_impl}"
    label += f", qp.scaling={scaling}" if scaling else ""
    label += "".join(f", qp.{k}={v}" for k, v in (qp_kw or {}).items())

    def settings_of(n):
        s = bench_settings(n, qp_impl)
        return dataclasses.replace(s, qp=dataclasses.replace(s.qp, scaling=scaling,
                                                             **(qp_kw or {})))

    def solve(n, batch, seed):
        problem, x0 = sphere_cap_nlp_batch(batch, n, seed=seed, dtype=torch.float32,
                                           device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sqp_solve_batch(problem, x0, None, settings_of(n), impl=impl)
        torch.cuda.synchronize()
        return problem, res, time.perf_counter() - t0

    for n, batch in configs:  # warm-up: torch.func tracing, allocator
        solve(n, batch, seed=100)
    results, launches, checks = {}, {}, {}
    for n, batch in configs:
        s = settings_of(n)
        if impl == "vmap":
            want = expect(polish_kkt_launches=s.polish_passes)
        elif qp_impl == "kernel":
            want = expect(sqp_step_launches=s.max_iter, polish_kkt_launches=s.polish_passes)
        else:
            chunks = -(-s.qp.max_iter // s.qp.check_termination)
            want = expect(admm_chunk_launches=s.max_iter * chunks,
                          polish_kkt_launches=s.polish_passes)
        reset_counts()
        checks[n] = host_checks()
        problem, res, wall = solve(n, batch, seed=3)
        checks[n] = host_checks() - checks[n]
        launches[n] = read_counts()
        if launches[n] != want:
            raise AssertionError(f"{label} n={n}: launches {launches[n]}, expected {want}")
        results[(n, batch)] = (problem, res, wall)

    summary = {}
    for (n, batch), (problem, res, wall) in results.items():
        status = res.info.status.cpu().numpy()
        x = res.x.cpu().numpy()
        lam = res.lam.cpu().numpy()
        if x.shape != (batch, n) or not np.isfinite(x).all() or not np.isfinite(lam).all():
            raise AssertionError(f"{label} n={n}: solution has the wrong shape or is not "
                                 "finite")
        solved = float(np.mean(status == SQPStatus.SOLVED))
        err_p99 = float(np.percentile(np.abs(x.astype(np.float64) - sphere_cap_solution(problem)), 99))
        cert = sphere_cert_1e4(problem.u[:, 0].double().cpu().numpy(), x, lam)
        times = [wall] + [solve(n, batch, seed=10 + r)[2] for r in range(3)]
        t = min(times)
        qp_iter = float(res.info.qp_solver_iter.float().mean())
        log(f"  {label} n={n} B={batch}: solved {solved:.4f}, err_p99 {err_p99:.3e}, "
            f"f64 cert(1e-4) {cert:.4f}, mean ADMM iterations {qp_iter:.1f}, "
            f"wall {t * 1e3:.3f} ms per batch "
            f"({t / batch * 1e6:.3f} us per solve, {batch / t:.1f} solves/s), host checks "
            f"{checks[n]} [min of {len(times)}; {card}]")
        if solved < 0.99:
            raise AssertionError(f"{label} n={n}: solved fraction {solved:.4f} < 0.99")
        if err_p99 > 1e-6:
            raise AssertionError(f"{label} n={n}: err_p99 {err_p99:.3e} > 1e-6")
        if cert < 0.99:
            raise AssertionError(f"{label} n={n}: f64 certificate {cert:.4f} < 0.99")
        summary[n] = dict(batch=batch, solved=solved, err_p99=err_p99, cert=cert,
                          ms=t * 1e3, solves_per_s=batch / t, host_checks=checks[n],
                          qp_iter=qp_iter)
    return dict(launches=launches, configs=summary)



# ---- G. Anderson acceleration inside the whole-solve kernels ---------------


def aa_settings(s, memory: int = 4):
    import dataclasses

    return dataclasses.replace(s, acceleration="anderson", anderson_memory=memory)


def aa_against_f64(label: str, t32, launch, plain, settings, x: str = "x",
                   relative: bool = False, bars: bool = True) -> dict:
    """The kernel with Anderson and its plain version with Anderson, both
    float32, each against the plain version in float64 under ROADMAP Queue
    3's float32 bars: x, z, y at ``EPOCH_TOL`` on the problems float64
    solved whose iteration and rho-update counts agree with it, and the
    kernel's counts agreeing on >= ``BTD_AGREE`` of what the plain float32
    version keeps.  With ``relative`` (where the plain float32 version
    itself parts from float64 by more than ``EPOCH_TOL``: Anderson's
    accept test flips on rounding) the kernel's largest difference must
    instead stay within twice the plain float32 version's (plus 1e-5).
    Without ``bars`` (where plain float32 itself agrees with float64 on
    too few problems for the shares to compare) the numbers are returned
    and no bar is held.  ``launch`` and ``plain`` take (operands, settings);
    ``plain_ms`` is the plain float32 call's time (CUDA events, no
    warm-up)."""
    import torch

    t64 = {k: (v.double() if v.dtype == torch.float32 else v) for k, v in t32.items()}
    p64 = plain(t64, settings)
    outs = {"kernel": launch(t32, settings)}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    outs["plain"] = plain(t32, settings)
    end.record()
    torch.cuda.synchronize()
    res = {}
    for name, out in outs.items():
        agree = (out.iter == p64.iter) & (out.rho_updates == p64.rho_updates)
        cmp = agree & p64.done
        e = 0.0
        for k in (x, "z", "y"):
            a, b = getattr(out, k)[cmp].double(), getattr(p64, k)[cmp]
            if bars and not relative and not torch.allclose(a, b, atol=EPOCH_TOL,
                                                            rtol=EPOCH_TOL):
                raise AssertionError(f"{label}: {name} {k} differs from f64 by "
                                     f"{max_err(a, b):.3e}")
            e = max(e, max_err(a, b))
        res[name] = dict(agree=float(agree.float().mean()), max_err=e)
    if bars and relative and not res["kernel"]["max_err"] <= 2 * res["plain"]["max_err"] + 1e-5:
        raise AssertionError(f"{label}: the kernel differs from f64 by "
                             f"{res['kernel']['max_err']:.3e}, over twice the plain f32 "
                             f"version's {res['plain']['max_err']:.3e}")
    if bars and res["kernel"]["agree"] < BTD_AGREE * res["plain"]["agree"]:
        raise AssertionError(f"{label}: the kernel agrees with f64 on {res['kernel']['agree']:.4f}, "
                             f"the plain float32 version on {res['plain']['agree']:.4f}")
    return dict(res, out=outs["kernel"], solved64=float(p64.done.float().mean()),
                plain_ms=start.elapsed_time(end))


def compare_aa(label: str, t32, launch, plain, s, bound_of, reps: int, x: str = "x",
               pairs: bool = False, relative: bool = False, dense_bound_of=None) -> dict:
    """One kernel with Anderson (``aa_against_f64``), timed with and without
    it (CUDA events) beside its plain version with it and the bound for the
    iterations it took (``bound_of(out, settings)``).  With ``pairs`` the
    settings must hold at least three chunks an epoch, and the run must show
    that the Anderson step did work: iteration counts that differ from the
    launch without it on some problems, and at least a quarter of the
    problems through three chunks or more, whose third chunk (in the first
    epoch, before any reset of the ring) solved a Gram of two pairs.
    ``relative`` as for ``aa_against_f64``.  ``dense_bound_of``, where
    ``bound_of`` counts A's nonzeros, gives the bound on dense A beside it."""
    from sqp_solver_tpu_torch.ops.qp_kernel import _schedule

    sa = aa_settings(s)
    r = aa_against_f64(label, t32, launch, plain, sa, x, relative)
    out_none = launch(t32, s)
    changed = deep = None
    if pairs:
        seg, cpe, _ = _schedule(sa)
        if cpe < 3:
            raise AssertionError(f"{label}: {cpe} chunks an epoch cannot show a Gram of two pairs")
        it_a = r["out"].iter
        changed = float((it_a != out_none.iter).float().mean())
        deep = float((it_a >= 3 * seg).float().mean())
        log(f"  {label}: iteration counts changed by Anderson on {changed:.4f} of the problems; "
            f"{deep:.4f} ran three chunks of {seg} or more (a Gram of >= 2 pairs)")
        if changed == 0.0 or deep < 0.25:
            raise AssertionError(f"{label}: Anderson changed the counts on {changed:.4f}, "
                                 f"{deep:.4f} reached a Gram of two pairs (bars > 0, 0.25)")
    ms = cuda_ms(lambda: launch(t32, sa), reps)
    ms_none = cuda_ms(lambda: launch(t32, s), reps)
    plain_ms = cuda_ms(lambda: plain(t32, sa), 1)
    bound_ms, bound_by = bound_of(r["out"], sa)
    dense = {}
    if dense_bound_of is not None:
        dense_ms, dense_by = dense_bound_of(r["out"], sa)
        dense = dict(bound_dense_ms=dense_ms, bound_dense_by=dense_by)
    it, it_none = float(r["out"].iter.float().mean()), float(out_none.iter.float().mean())
    log(f"  {label} with Anderson (k={sa.anderson_memory}): f64 solved {r['solved64']:.4f}; "
        f"iter and rho agree with f64 on kernel {r['kernel']['agree']:.4f} / plain f32 "
        f"{r['plain']['agree']:.4f}, max diff {r['kernel']['max_err']:.3e} / "
        f"{r['plain']['max_err']:.3e}; kernel {ms:.3f} ms over a mean of {it:.1f} ADMM "
        f"iterations (without Anderson {ms_none:.3f} ms, {it_none:.1f} iterations), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        + (f" on A's nonzeros, {dense['bound_dense_ms']:.4f} ms ({dense['bound_dense_by']}) on "
           "dense A" if dense else ""))
    return dict(label=label, anderson_memory=sa.anderson_memory, ms=ms, ms_none=ms_none,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, **dense, mean_iter=it,
                mean_iter_none=it_none, max_abs_err=r["kernel"]["max_err"],
                agree_kernel=r["kernel"]["agree"], agree_plain=r["plain"]["agree"],
                iter_changed=changed, two_pair_share=deep)


def aa_report(dev, phase_libs: dict, card: str) -> list:
    """Leg G's Anderson kernels (``aa_cases``): where each keeps the step's
    state (its Gram always in shared memory; its ring in shared memory or
    the device workspace), the blocks an SM of the kernel with Anderson and
    of the kernel without it (the runtime's occupancy at each one's shared
    memory), held against the rule's Python mirror
    (``ops/qp_kernel.py:anderson_placement``); and the step's split a chunk
    from the phase-clock builds (``tools/kernel_ab.py:aa_split``)."""
    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.tools.kernel_ab import AA_PHASES, SOURCES, aa_split

    rows = []
    for c in aa_cases(dev):
        kw = dict(bb=c.get("bb"), cluster=c.get("cluster"))
        on_card = qk.anderson_placement_card(c["placement"], c["n"], c["m"], c["memory"], **kw)
        mirror = qk.anderson_placement(c["placement"], c["n"], c["m"], c["memory"],
                                       twin_blocks=on_card.get("twin_blocks"), **kw)
        differ = [k for k in mirror if k in on_card and mirror[k] != on_card[k]]
        if differ:
            raise AssertionError(f"{c['label']}: the launcher's placement {on_card} differs from "
                                 f"the rule's mirror {mirror} in {differ}")
        if on_card["ring"] and on_card["blocks"] < on_card["twin_blocks"]:
            raise AssertionError(f"{c['label']}: the ring on chip leaves {on_card['blocks']} "
                                 f"blocks an SM, the kernel without Anderson "
                                 f"{on_card['twin_blocks']}")
        split = aa_split(phase_libs[SOURCES[c["kernel"]]], c)
        per = split["cycles_per_chunk"]
        blocks = (f"blocks an SM {on_card['blocks']} with Anderson, {on_card['twin_blocks']} "
                  f"without ({on_card['smem_bytes']} / {on_card['twin_smem_bytes']} bytes of "
                  "shared memory a block)" if "blocks" in on_card else
                  f"{on_card['smem_bytes']} bytes of shared memory a block")
        log(f"  {c['label']}: ring {'on chip' if on_card['ring'] else 'in the workspace'}, Gram "
            f"on chip; {blocks}; the step {split['step_per_chunk']:.0f} cycles a chunk a block ("
            + ", ".join(f"{p[2:]} {per[p]:.0f}" for p in AA_PHASES)
            + f"), the plain stats {per['stats']:.0f}, over {split['chunks']:.1f} chunks [{card}]")
        rows.append(dict(case=c["label"], placement=on_card, mirror=mirror, **split))
    return rows


def run_aa_pair(label: str, card: str, make, solve, settings, want: dict, metrics,
                fewer: bool = False) -> dict:
    """An entry point with ``acceleration="none"`` and with Anderson:
    ``make(seed)`` a problem (outside the walls), ``solve(problem,
    settings)`` its result; a warm-up, the run on seed 0 with the counters
    from 0 (asserted against ``want``), walls min of 3 seeds;
    ``metrics(problem, result, settings)`` gives the solved fraction, the
    float64 test and the mean ADMM iterations (a dict).  ``fewer`` asserts
    that Anderson takes fewer mean iterations."""
    import torch

    problems = {seed: make(seed) for seed in (100, 0, 1, 2)}

    def timed(st, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(problems[seed], st)
        torch.cuda.synchronize()
        return problems[seed], res, time.perf_counter() - t0

    out = {}
    for acc, st in (("none", settings), ("anderson", aa_settings(settings))):
        timed(st, 100)  # warm-up
        reset_counts()
        problem, res, wall = timed(st, 0)
        c = read_counts()
        if c != expect(**want):
            raise AssertionError(f"{label} {acc}: launches {c}, expected {want}")
        walls = [wall] + [timed(st, 1 + r)[2] for r in range(2)]
        out[acc] = dict(ms=min(walls) * 1e3, counts=c, **metrics(problem, res, st))
    a, p = out["anderson"], out["none"]
    log(f"  {label}: with Anderson {a['ms']:.3f} ms, mean ADMM iterations {a['mean_iter']:.1f}, "
        f"solved {a['solved']:.4f}, f64 test {a['f64']:.4f}; without {p['ms']:.3f} ms, "
        f"{p['mean_iter']:.1f} iterations, solved {p['solved']:.4f}, f64 test {p['f64']:.4f} "
        f"[min of 3; {card}]")
    if fewer and not a["mean_iter"] < p["mean_iter"]:
        raise AssertionError(f"{label}: Anderson takes {a['mean_iter']:.1f} mean iterations, "
                             f"without it {p['mean_iter']:.1f}")
    return out


def aa_qp_metrics(qp, res, s) -> dict:
    """Solved fraction, the share passing the float64 OSQP test (10x) and
    the mean iterations; every SOLVED problem must pass the test."""
    ok, _ = qp_osqp64(qp, res, s.eps_abs, s.eps_rel)
    solved = (res.info.status == 0).cpu().numpy()
    if not ok[solved].all():
        raise AssertionError(f"{int((~ok[solved]).sum())} SOLVED problems fail the f64 "
                             "OSQP test")
    return dict(solved=float(solved.mean()), f64=float(ok.mean()),
                mean_iter=float(res.info.iter.float().mean()))


def k3_aa_settings():
    """bench.py:1387-1396's Anderson settings (memory 4) of K3's leg G row."""
    from sqp_solver_tpu_torch.qp.types import QPSettings

    return QPSettings(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=2000,
                      check_termination=25, schedule="fixed")


def k1_aa_settings():
    """K1's leg G row: the main path's inner QP run to 200 iterations at
    1e-5 (at 50 iterations and 1e-4 most stop at max_iter, before Anderson
    has pairs to work with)."""
    import dataclasses

    return dataclasses.replace(main_qp_settings(), eps_abs=1e-5, eps_rel=1e-5, max_iter=200)


def aa_cases(dev) -> list:
    """Leg G's Anderson launches (memory 4), each with a launcher that takes
    a kernel library, for ``tools/kernel_ab.py`` and leg G's split and
    placement: K1 n = 32, B = 4096; K3 random n = 32, m = 33, B = 4096 in its
    warp layout (the rule's) and its block layout; K6 on the structured MPC
    horizon 64, B = 256 and K7 on the NLP step horizon 32, B = 64, each at
    its cell's settings and on a cluster with chunks of 10; K6 on the MPC
    at horizon 32, B = 4096, one block a problem, chunks of 10 (where the
    kernel without Anderson gets two blocks an SM, so the Anderson kernel's
    registers are capped: csrc/qp_kernel_btd.cu:btd_aa_kernel); the wide K6
    on random bands at bb = 64 and the wide K7 at the NLP's block-64 shape,
    chunks of 10; then K1 and the K6 cluster with chunks of 10 at memory 8,
    past the pairs one reduction takes (kAaSlots).  Each case names its
    kernel (``kernel``: the A/B tool's key; ``placement``:
    ``ops/qp_kernel.py:anderson_placement``'s), its memory, its thread
    blocks, its chunk length and its shape, and ``launch_none``: the same
    launch without Anderson."""
    import dataclasses

    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    cases = []
    s1 = k1_aa_settings()
    t = step_operands(4096, 32, dev)

    def k1(lib, st, t=t):
        return step_call(qk._sqp_step_launch, t, st, lib=lib)

    k1_case = dict(label="K1 Anderson n=32 B=4096", kernel="k1aa", placement="K1", memory=4,
                   n=32, m=33, batch=4096, blocks=4096, seg=s1.check_termination, reps=10,
                   launch=lambda lib, k=4: k1(lib, aa_settings(s1, k)),
                   launch_none=lambda lib: k1(lib, s1))
    cases.append(k1_case)
    s3 = k3_aa_settings()
    t = qp_operands("random", 4096, 32, dev)
    for layout in ("warp", "block"):
        def k3(lib, st, t=t, layout=layout):
            return qp_raw(lambda *a: qk._qp_solve_launch(*a, lib=lib, layout=layout), t, st)

        cases.append(dict(
            label=f"K3 Anderson random n=32 m=33 B=4096 ({layout} layout)", kernel="k3aa",
            placement=f"K3-{layout}", memory=4, n=32, m=33, batch=4096,
            blocks=2048 if layout == "warp" else 4096, seg=s3.check_termination, reps=5,
            launch=lambda lib, k3=k3: k3(lib, aa_settings(s3)),
            launch_none=lambda lib, k3=k3: k3(lib, s3)))
    runs = [(c, key, label, st, cl)
            for c, key in ((btd_mpc_case(256, dev), "k6aa"), (btd_step_case(32, 64, dev), "k7aa"))
            for label, st, cl in (("the cell's settings", c["settings"], None),
                                  ("cluster, chunks of 10", aa_pair_settings(c["settings"]), 2))]
    c = btd_mpc_case(4096, dev, horizon=32)
    runs.append((c, "k6aa", "one block a problem, chunks of 10", aa_pair_settings(c["settings"]),
                 1))
    for c, key, label, st, cl in runs:
        def btd(lib, st, c=c, cl=cl):
            return btd_launch(c["t"], st, c["check_infeas"], cluster=cl, lib=lib)

        cases.append(dict(
            label=f"{c['label']} Anderson, {label}", kernel=key, placement=key[:2].upper(),
            memory=4, n=c["n"], m=c["m"], bb=c["bb"], batch=c["batch"], cluster=cl or 2,
            blocks=(cl or 2) * c["batch"], seg=st.check_termination, reps=5,
            launch=lambda lib, k=4, btd=btd, st=st: btd(lib, aa_settings(st, k)),
            launch_none=lambda lib, btd=btd, st=st: btd(lib, st)))
    for c, key in ((btd_random_case(256, 4, 64, 384, dev), "k6waa"),
                   (btd_wide_step_case(64, 2, 64, 224, dev), "k7waa")):
        st = dataclasses.replace(c["settings"], check_termination=10)

        def wide(lib, st, c=c):
            return btd_launch(c["t"], st, c["check_infeas"], lib=lib)

        cases.append(dict(
            label=f"{c['label']} bb=64 Anderson, chunks of 10", kernel=key,
            placement="wide", memory=4, n=c["n"], m=c["m"], bb=64, batch=c["batch"], cluster=2,
            blocks=2 * c["batch"], seg=10, reps=3,
            launch=lambda lib, wide=wide, st=st: wide(lib, aa_settings(st)),
            launch_none=lambda lib, wide=wide, st=st: wide(lib, st)))
    k6_case = next(c for c in cases if c["kernel"] == "k6aa" and "chunks of 10" in c["label"])
    for c in (k1_case, k6_case):
        cases.append(dict(c, label=f"{c['label']}, memory 8", memory=8,
                          launch=lambda lib, c=c: c["launch"](lib, 8)))
    return cases


def aa_pair_settings(s):
    """``s`` with chunks of 10 iterations and rho every 50 (five chunks an
    epoch, as the SQP cells' inner QPs of bench.py:455-470 check), eps
    1e-5 and 300 iterations, alpha 1.6: the ring holds several pairs.  At
    the structured cells' own settings K6 checks and adapts rho every 25
    iterations, so its ring is emptied before it holds a pair, and K7 (25 /
    50) holds one at most."""
    import dataclasses

    return dataclasses.replace(s, alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=300,
                               check_termination=10, adaptive_rho=True,
                               adaptive_rho_interval=50)


def run_anderson(dev, card: str, main_run: dict, reps: int = 5) -> dict:
    """Leg G: K3, K1, K6 and K7 with Anderson (memory 4), each path beside
    the same call without it, and each kernel against its plain version
    (``compare_aa``).  K6 (a cluster) and K7 are compared twice: at their
    cells' settings, where the ring holds a pair at most (the overhead of
    the step), and at ``aa_pair_settings``, where it holds several.
    Returns the rows and the paths' launch counts."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_qp_stagewise_batch, random_qp_batch
    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp.types import QPSettings

    rows, paths, runs = {}, {}, {}
    # K3: bench.py:1387-1396's settings on the one-shot cell's shape
    batch, n, m = 4096, 32, 33
    s3 = QPSettings(alpha=1.6, eps_abs=1e-6, eps_rel=1e-6, max_iter=2000, check_termination=25,
                    schedule="fixed")
    runs["k3"] = run_aa_pair(
        f"K3 qp_solve_batch(impl='kernel') random n={n} m={m} B={batch}", card,
        lambda seed: random_qp_batch(batch, n, m, seed=3 + seed, device=dev),
        lambda qp, st: qp_solve_batch(qp, st, impl="kernel"),
        s3, dict(qp_solve_launches=1), aa_qp_metrics, fewer=True)
    a3 = runs["k3"]["anderson"]
    if a3["solved"] < 0.99 or a3["f64"] < 0.99:
        raise AssertionError(f"K3 with Anderson: solved {a3['solved']:.4f}, f64 OSQP test "
                             f"{a3['f64']:.4f} (bars 0.99)")
    paths.update(aa_k3=runs["k3"]["anderson"]["counts"])
    t = qp_operands("random", batch, n, dev)
    rows["qp_solve"] = compare_aa(
        f"K3 random n={n} m={m} B={batch}", t,
        lambda t, st: qp_raw(qk._qp_solve_launch, t, st),
        lambda t, st: qp_raw(qk.qp_solve_reference, t, st), s3,
        lambda out, st: qp_bound(out, st, batch, n, m), reps)

    # K1: the SQP headline n = 32, B = 4096 with qp.acceleration="anderson"
    k1_run = run_main_path([(32, 4096)], dev, card, qp_kw=dict(acceleration="anderson"))
    a1, p1 = k1_run["configs"][32], main_run["configs"][32]
    log(f"  K1 tier n=32 B=4096: with Anderson {a1['ms']:.3f} ms, mean ADMM iterations "
        f"{a1['qp_iter']:.1f}, solved {a1['solved']:.4f}, err_p99 {a1['err_p99']:.3e}, f64 cert "
        f"{a1['cert']:.4f}; without (phase 4) {p1['ms']:.3f} ms, {p1['qp_iter']:.1f} iterations "
        f"[{card}]")
    runs["k1"] = dict(anderson=a1, none=p1)
    paths.update(aa_sqp_main_n32=k1_run["launches"][32])
    # the main path's operands, its inner QP run to 200 iterations at 1e-5
    # (at 50 iterations and 1e-4 most stop at max_iter, before Anderson
    # has pairs to work with)
    t = step_operands(4096, 32, dev)
    rows["sqp_step"] = compare_aa(
        "K1 n=32 B=4096", t, lambda t, st: step_call(qk.sqp_step_kernel, t, st),
        lambda t, st: step_call(qk.sqp_step_reference, t, st),
        dataclasses.replace(main_qp_settings(), eps_abs=1e-5, eps_rel=1e-5, max_iter=200),
        lambda out, st: step_bound(out, st, 4096, 32), reps, x="p")

    # K6: the structured MPC at horizon 64, B = 256 (bench.py:512's settings)
    s6 = btd_qp_settings()

    runs["k6"] = run_aa_pair(
        "K6 structured MPC horizon 64 B=256", card,
        lambda seed: mpc_qp_stagewise_batch(256, horizon=64, seed=seed, device=dev)[0],
        lambda qp, st: qp_solve_batch(qp, st, impl="kernel"), s6,
        dict(qp_solve_btd_launches=1), aa_qp_metrics)
    paths.update(aa_btd_mpc_b256=runs["k6"]["anderson"]["counts"])
    c = btd_mpc_case(256, dev)
    rows["qp_solve_btd_overhead"] = compare_aa(
        f"{c['label']} (the cell's settings: the step's overhead)", c["t"],
        lambda t, st: btd_launch(t, st, True), lambda t, st: btd_plain(t, st, True),
        c["settings"], lambda out, st: btd_bound(out, st, c["batch"], c["n"], c["m"], c["bb"]),
        reps)
    rows["qp_solve_btd"] = compare_aa(
        f"{c['label']} cluster, chunks of 10", c["t"],
        lambda t, st: btd_launch(t, st, True, cluster=2), lambda t, st: btd_plain(t, st, True),
        aa_pair_settings(c["settings"]),
        lambda out, st: btd_bound(out, st, c["batch"], c["n"], c["m"], c["bb"]), reps,
        pairs=True)

    # K7: one structured NLP step (horizon 32, B = 64) through its entry
    c = btd_step_case(32, 64, dev)
    tt = c["t"]

    def step_solve(_, st):  # one instance: the NLP's first-iteration QPs
        return qb.btd_step_kernel(tt["pd"], tt["pe"], tt["J"], tt["g"], tt["l"], tt["u"],
                                  tt["active"], tt["x"], tt["z"], tt["y"], st,
                                  rho_in=tt["rho_in"])

    def step_metrics(_, out, st):
        act = tt["active"]
        return dict(solved=float(out.done[act].float().mean()), f64=float("nan"),
                    mean_iter=float(out.iter[act].float().mean()))

    runs["k7"] = run_aa_pair(c["label"], card, lambda seed: None, step_solve, c["settings"],
                             dict(btd_step_launches=1), step_metrics)
    paths.update(aa_btd_step_h32=runs["k7"]["anderson"]["counts"])
    rows["btd_step_overhead"] = compare_aa(
        f"{c['label']} (the cell's settings: the step's overhead)", tt,
        lambda t, st: btd_launch(t, st, False), lambda t, st: btd_plain(t, st, False),
        c["settings"], lambda out, st: btd_bound(out, st, c["batch"], c["n"], c["m"], c["bb"]),
        reps)
    rows["btd_step"] = compare_aa(
        f"{c['label']} cluster, chunks of 10", tt,
        lambda t, st: btd_launch(t, st, False, cluster=2), lambda t, st: btd_plain(t, st, False),
        aa_pair_settings(c["settings"]),
        lambda out, st: btd_bound(out, st, c["batch"], c["n"], c["m"], c["bb"]), reps,
        pairs=True)
    torch.cuda.synchronize()
    return dict(rows=rows, runs=runs, counts=paths)


AA_LONG_MEMORY = 40


def aa_long_settings(s, memory: int = AA_LONG_MEMORY):
    """``s`` with Anderson at ``memory`` in chunks of 2 iterations and rho
    every 120 (60 chunks an epoch, so that the ring fills and wraps before
    a rho change empties it), eps 1e-6 and 300 iterations, alpha 1.6."""
    return dataclasses.replace(s, acceleration="anderson", anderson_memory=memory, alpha=1.6,
                               eps_abs=1e-6, eps_rel=1e-6, max_iter=300, check_termination=2,
                               adaptive_rho=True, adaptive_rho_interval=120)


def aa_long_cases(dev, lib=None) -> list:
    """Leg G's kernels with Anderson past memory 32, at leg G's shapes
    (``aa_cases``): K1 n = 32, B = 4096; K3 random n = 32, m = 33, B = 4096
    in its warp and block layouts; K6 on the structured MPC horizon 64,
    B = 256 and K7 on the NLP step horizon 32 (B = 1024), each on a
    cluster; the wide K6 on random bands at bb = 64 and the wide K7 at the
    NLP's block-64 shape (B = 1024 each), and the compact route past
    internal block 128 on random bands at bb = 256 (B = 32, the rule's
    cluster for the nonzeros a block holds, ``nnz``).  Each: its label,
    operands, launch and plain call (each taking operands and settings),
    base settings, the iterate's name, its placement's kernel and shape
    (the wide kernel's cases also their ``tools/kernel_ab.py`` key), whether
    it is held relative to the plain float32 version (the wide K6, as at
    memory 4) and whether by ``aa_against_f64``'s bars (``bars``; not the
    compact route's, which the fixed-rho run holds), ``bound_of(out,
    settings)``, and ``entry``: the kernel line's entry its timed row
    joins.  Each launch takes a kernel library (``lib``,
    the package's by default), as ``tools/kernel_ab.py`` passes one
    (:func:`aa_memory_cases`); ``lib`` here gives the compact route's
    cluster."""
    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    cases = [dict(label="K1 n=32 B=4096", kernel="K1", n=32, m=33, t=step_operands(4096, 32, dev),
                  batch=4096,
                  launch=lambda t, st, lib=None: step_call(qk._sqp_step_launch, t, st, lib=lib),
                  plain=lambda t, st: step_call(qk.sqp_step_reference, t, st),
                  settings=k1_aa_settings(), x="p", kw={}, entry="sqp_step",
                  bound_of=lambda out, st: step_bound(out, st, 4096, 32))]
    t = qp_operands("random", 4096, 32, dev)
    for layout in ("warp", "block"):
        cases.append(dict(
            label=f"K3 random n=32 m=33 B=4096 ({layout} layout)", kernel=f"K3-{layout}", n=32,
            m=33, t=t, batch=4096, launch=lambda t, st, lib=None, layout=layout: qp_raw(
                lambda *a: qk._qp_solve_launch(*a, layout=layout, lib=lib), t, st),
            plain=lambda t, st: qp_raw(qk.qp_solve_reference, t, st), settings=k3_aa_settings(),
            x="x", kw={}, entry="qp_solve",
            bound_of=lambda out, st: qp_bound(out, st, 4096, 32, 33)))
    # K7 and the wide kernels at B = 1024 (leg G's shapes, more problems):
    # with a check every 2 iterations few float32 runs stop at float64's
    # iteration, and the share that does needs the problems to be an
    # estimate
    for c, kernel, entry in ((btd_mpc_case(256, dev), "K6", "qp_solve_btd"),
                             (btd_step_case(32, 1024, dev), "K7", "btd_step")):
        ci = c["check_infeas"]
        cases.append(dict(
            label=f"{c['label']} cluster", kernel=kernel, n=c["n"], m=c["m"], t=c["t"],
            batch=c["batch"],
            launch=lambda t, st, lib=None, ci=ci: btd_launch(t, st, ci, cluster=2, lib=lib),
            plain=lambda t, st, ci=ci: btd_plain(t, st, ci), settings=c["settings"], x="x",
            kw=dict(bb=c["bb"], cluster=2), entry=entry,
            bound_of=lambda out, st, c=c: btd_bound(out, st, c["batch"], c["n"], c["m"],
                                                    c["bb"])))
    for c, entry, key in ((btd_random_case(1024, 4, 64, 384, dev), "qp_solve_btd_wide", "k6waa"),
                          (btd_wide_step_case(1024, 2, 64, 224, dev), "btd_step_wide", "k7waa"),
                          (btd_random_case(32, 2, 256, 200, dev), "qp_solve_btd_wide", "k6xaa")):
        ci, bb, nnz = c["check_infeas"], c["bb"], btd_nnz(c)
        cluster = qb.cluster_size(c["n"], c["m"], bb, c["batch"], lib=lib, nnz=nnz)
        # past 128 plain float32 stops at float64's iteration on 1 of the 32
        # problems (chunks of 2): the fixed-rho run holds the kernel there
        bars = bb <= qb.COMPACT_ABOVE
        cases.append(dict(
            label=f"wide {c['label']} bb={bb}", kernel="wide", key=key, n=c["n"], m=c["m"],
            t=c["t"], batch=c["batch"],
            launch=lambda t, st, lib=None, ci=ci: btd_launch(t, st, ci, lib=lib),
            plain=lambda t, st, ci=ci: btd_plain(t, st, ci), settings=c["settings"], x="x",
            kw=dict(bb=bb, cluster=cluster), nnz=nnz, relative=ci, bars=bars, entry=entry,
            bound_of=lambda out, st, c=c: btd_bound(out, st, c["batch"], c["n"], c["m"],
                                                    c["bb"], A=c["t"]["J"])))
    return cases


# tools/kernel_ab.py's key of each aa_long_cases kernel (the wide kernel's
# cases name theirs: k6waa, k7waa, k6xaa)
AA_LONG_KEYS = {"K1": "k1aa", "K3-warp": "k3aa", "K3-block": "k3aa", "K6": "k6aa", "K7": "k7aa"}


def aa_memory_cases(dev, memory: int = AA_LONG_MEMORY, long_cases=None, lib=None) -> list:
    """Leg G's cases past memory 32 (``long_cases``, by default
    ``aa_long_cases``: chunks of 2, rho every 120) at ``memory``, in the
    form of ``aa_cases`` for ``tools/kernel_ab.py --memory``: ``launch(lib)``
    at that memory and ``launch_none(lib)`` at memory 4 in the same
    settings (the memory-4 row kept beside each timing), each case's thread
    blocks and chunk length (``lib``: :func:`aa_long_cases`')."""
    cases = []
    for c in long_cases if long_cases is not None else aa_long_cases(dev, lib):
        st, st4 = aa_long_settings(c["settings"], memory), aa_long_settings(c["settings"], 4)
        blocks = c["batch"] // 2 if c["kernel"] == "K3-warp" else c["batch"] * c["kw"].get(
            "cluster", 1)
        cases.append(dict(
            label=f"{c['label']} Anderson memory {memory}",
            kernel=c.get("key") or AA_LONG_KEYS[c["kernel"]],
            placement=c["kernel"], memory=memory, n=c["n"], m=c["m"], batch=c["batch"],
            blocks=blocks, seg=st.check_termination, reps=2, none_label="memory 4",
            nnz=c.get("nnz"), **c["kw"],
            launch=lambda lib, c=c, st=st: c["launch"](c["t"], st, lib=lib),
            launch_none=lambda lib, c=c, st4=st4: c["launch"](c["t"], st4, lib=lib)))
    return cases


def aa_fixed_against_f64(label: str, c: dict, st, iters: int) -> dict:
    """Anderson at ``st``'s memory with a fixed rho for ``iters`` iterations
    and no early exit (every problem's ring fills and wraps): the kernel and
    the plain version in float32 each against the plain version in float64,
    as the largest per-problem error relative to 1 + the float64 iterate's
    largest entry over x (p), z, y; the kernel's must stay within twice the
    plain float32 version's (plus 1e-5), as leg N's fixed-rho run.  Where
    the problems have equality rows (the MPC, the NLP's dynamics), this is
    the comparison that sees the trajectories: float32 runs that stop on
    their own seldom stop at float64's iteration."""
    import torch

    s = dataclasses.replace(st, adaptive_rho=False, max_iter=iters, eps_abs=1e-12,
                            eps_rel=1e-12)
    t32 = c["t"]
    t64 = {k: (v.double() if v.is_floating_point() else v) for k, v in t32.items()}
    p64 = c["plain"](t64, s)
    err = {}
    for name, out in (("kernel", c["launch"](t32, s)), ("plain", c["plain"](t32, s))):
        torch.cuda.synchronize()
        err[name] = max(float(((getattr(out, k).double() - getattr(p64, k)).abs().amax(1)
                               / (1 + getattr(p64, k).abs().amax(1))).max())
                        for k in (c["x"], "z", "y"))
    if not err["kernel"] <= 2 * err["plain"] + 1e-5:
        raise AssertionError(f"{label}: {iters} iterations at a fixed rho, the kernel's error "
                             f"against f64 {err['kernel']:.3e} exceeds twice the plain f32 "
                             f"version's {err['plain']:.3e}")
    return err


def run_anderson_long(dev, card: str, phase_libs: dict, reps: int = 2) -> dict:
    """Leg G past memory 32: each Anderson kernel at memory 40
    (``aa_long_cases``, ``aa_long_settings``: chunks of 2, rho every 120)
    held against its plain version and float64 under the bars of the
    memory-4 cases (``aa_against_f64``), a quarter or more of the problems
    running past the chunk at which the ring wraps, and with a fixed rho
    for 100 iterations, every problem past the wrap
    (``aa_fixed_against_f64``); the Gram area's and the
    ring's placement and the blocks an SM from the launcher
    (``anderson_placement_card``) against the rule's mirror, with where
    the chunk's system went (``solve``), and the step's split a chunk from
    the phase-clock build of the kernel's Anderson unit (``phase_libs``,
    ``tools/kernel_ab.py:aa_split``); and each kernel timed at memory 40
    beside memory 4 in the same settings, with the plain version and the
    bound (``timed``: the rows by the kernel line's entry)."""
    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.tools.kernel_ab import AA_PHASES, SOURCES, aa_split

    rows, timed = [], {}
    k = AA_LONG_MEMORY
    for c in aa_long_cases(dev):
        st = aa_long_settings(c["settings"])
        r = aa_against_f64(f"{c['label']} memory {k}", c["t"], c["launch"], c["plain"], st,
                           c["x"], c.get("relative", False), c.get("bars", True))
        wrapped = float((r["out"].iter >= 2 * (k + 2)).float().mean())
        if wrapped < 0.25:
            raise AssertionError(f"{c['label']} memory {k}: {wrapped:.4f} of the problems ran "
                                 f"past the ring's wrap at {2 * (k + 2)} iterations (bar 0.25)")
        fixed = aa_fixed_against_f64(f"{c['label']} memory {k}", c, st, 100)
        on_card = qk.anderson_placement_card(c["kernel"], c["n"], c["m"], k, nnz=c.get("nnz"),
                                             **c["kw"])
        wide = None
        if c["kernel"] == "wide":  # the layouts with each reserve the rule weighs

            def wide(reserve, c=c):
                return qb.wide_layout(c["n"], c["m"], c["kw"]["bb"], nnz=c.get("nnz"),
                                      reserve=reserve)
        mirror = qk.anderson_placement(c["kernel"], c["n"], c["m"], k,
                                       twin_blocks=on_card.get("twin_blocks"), wide=wide,
                                       **c["kw"])
        differ = [key for key in mirror if key in on_card and mirror[key] != on_card[key]]
        if differ:
            raise AssertionError(f"{c['label']} memory {k}: the launcher's placement {on_card} "
                                 f"differs from the rule's mirror {mirror} in {differ}")
        blocks = (f", blocks an SM {on_card['blocks']} with Anderson, "
                  f"{on_card['twin_blocks']} without" if "blocks" in on_card else "")
        solve = f", the chunk's system {on_card['solve']}" + (
            f" ({on_card['solve_floats']} floats of shared memory a block)"
            if on_card["solve_floats"] else "")
        log(f"  {c['label']} memory {k} (chunks of 2, rho every 120): Gram area "
            f"{'in shared memory' if on_card['gram'] else 'in the workspace'}{solve}, ring "
            f"{'in shared memory' if on_card['ring'] else 'in the workspace'} "
            f"({on_card['smem_bytes']} bytes of shared memory a block{blocks}); iter and rho "
            f"agree with f64 on kernel {r['kernel']['agree']:.4f} / plain f32 "
            f"{r['plain']['agree']:.4f}, max diff {r['kernel']['max_err']:.3e} / "
            f"{r['plain']['max_err']:.3e}"
            + ("" if c.get("bars", True) else " (no bar: too few agree to compare)")
            + f"; {wrapped:.4f} of the problems past the ring's wrap, "
            f"mean ADMM iterations {float(r['out'].iter.float().mean()):.1f}; 100 iterations at "
            f"a fixed rho, relative error against plain f64 kernel {fixed['kernel']:.3e} / plain "
            f"f32 {fixed['plain']:.3e} [{card}]")
        row = dict(case=c["label"], memory=k, placement=on_card, wrapped=wrapped, fixed=fixed,
                   agree_kernel=r["kernel"]["agree"], agree_plain=r["plain"]["agree"],
                   max_abs_err=r["kernel"]["max_err"], max_abs_err_plain=r["plain"]["max_err"])
        # the step's split a chunk, from the phase-clock build of its unit
        mc = aa_memory_cases(dev, k, [c])[0]
        split = aa_split(phase_libs[SOURCES[mc["kernel"]]], mc)
        per = split["cycles_per_chunk"]
        log(f"  {c['label']} memory {k}: the step {split['step_per_chunk']:.0f} cycles a "
            "chunk a block (" + ", ".join(f"{p[2:]} {per[p]:.0f}" for p in AA_PHASES)
            + f"), the solve {per['aasolve'] / split['step_per_chunk']:.3f} of it; the "
            f"plain stats {per['stats']:.0f}, over {split['chunks']:.1f} chunks [{card}]")
        row["split"] = split
        t, launch = c["t"], c["launch"]
        st4 = aa_long_settings(c["settings"], 4)
        ms, ms4 = cuda_ms(lambda: launch(t, st), reps), cuda_ms(lambda: launch(t, st4), reps)
        out4 = launch(t, st4)
        plain_ms = r["plain_ms"]  # its float32 call above: seconds, no warm-up needed
        it, it4 = float(r["out"].iter.float().mean()), float(out4.iter.float().mean())
        bound_ms, by = c["bound_of"](r["out"], st)
        log(f"  {c['label']} memory {k}: kernel {ms:.3f} ms over a mean of {it:.1f} ADMM "
            f"iterations; memory 4 in the same settings {ms4:.3f} ms over {it4:.1f}; plain "
            f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({by}) [{card}]")
        row.update(ms=ms, ms_memory4=ms4, mean_iter=it, mean_iter_memory4=it4,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        timed.setdefault(c["entry"], []).append(row)
        rows.append(row)
    return dict(rows=rows, timed=timed)


# ---- H. the linear-solver backends -------------------------------------------


def counted_run(label, fn, want, counts: dict, runs: int = 3, warm: bool = True):
    """A warm-up (unless ``warm`` is False), then ``runs`` runs, the first
    with the counters from 0, its launches asserted to be ``want`` and
    kept in ``counts[label]``: (its result, its host checks, the min wall
    seconds)."""
    if warm:
        fn()
    reset_counts()
    checks = host_checks()
    res, wall = timed_wall(fn, 1)
    checks = host_checks() - checks
    c = read_counts()
    if c != expect(**want):
        raise AssertionError(f"{label}: launches {c}, expected {want}")
    counts[label] = c
    return res, checks, min([wall] + [timed_wall(fn, 1)[1] for _ in range(runs - 1)])


def timed_wall(fn, runs: int):
    """(result of the first run, min wall seconds over ``runs`` runs, each
    closed by a synchronize)."""
    import torch

    walls, first = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        first = out if first is None else first
    return first, min(walls)


def sparse_cg_settings():
    """The sparse legs' cg settings (bench.py:735-738)."""
    from sqp_solver_tpu_torch.qp.types import QPSettings

    return QPSettings(linear_solver="cg", eps_abs=1e-4, eps_rel=1e-4, max_iter=2000,
                      check_termination=25, adaptive_rho=True)


def run_backends(dev, card: str, btd_mpc_run: dict) -> dict:
    """Leg H: the linear-solver backends at the JAX bench's shapes, each
    run with the counters from 0 (no kernel launch but the SQP polish's K2)
    after a warm-up; walls min of 3 (2 at n = 4096), host checks, solved
    fraction and the float64 tests of the cells they mirror."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch, sphere_cap_solution
    from sqp_solver_tpu_torch.models.mpc import mpc_qp_stagewise_batch, random_qp_batch
    from sqp_solver_tpu_torch.models.sparse import sparse_qp_pair
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch, sqp_solve_batch
    from sqp_solver_tpu_torch.qp import qp_solve
    from sqp_solver_tpu_torch.qp.types import QPSettings, QuadraticProblem
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    out, counts = {}, {}
    run = functools.partial(counted_run, counts=counts)

    # blocktri on the vmap and fused tiers (bench.py:508-518), B = 256
    qp_mpc, blk = mpc_qp_stagewise_batch(256, horizon=64, seed=0, device=dev)
    bt = QPSettings(adaptive_rho=True, max_iter=100, linear_solver="schur_block_tridiag",
                    block_size=blk)
    side = btd_mpc_run["runs"][256]
    for label, st, impl in (("blocktri_vmap", bt, "vmap"),
                            ("blocktri_fused", dataclasses.replace(bt, schedule="fixed"),
                             "fused")):
        fn = functools.partial(qp_solve_batch, qp_mpc, st, impl=impl)
        res, checks, wall = run(label, fn, {})
        m = aa_qp_metrics(qp_mpc, res, st)
        log(f"  {label} MPC horizon 64 B=256: {wall * 1e3:.3f} ms ({256 / wall:.1f} solves/s), "
            f"solved {m['solved']:.4f}, mean iter {m['mean_iter']:.1f}, host checks {checks}, "
            f"SOLVED pass the f64 OSQP test ({m['f64']:.4f} of all); beside K6 "
            f"{side['ms']:.3f} ms, dense K3 {side['dense_ms']:.3f} ms [min of 3; {card}]")
        if m["solved"] < 0.99 or m["f64"] < 0.99:
            raise AssertionError(f"{label}: solved {m['solved']:.4f}, f64 test {m['f64']:.4f} "
                                 "(bars 0.99)")
        out[label] = dict(ms=wall * 1e3, host_checks=checks, **m)

    # kkt_ldlt and schur_cholesky_tri on the vmap one-shot QP, B = 1024
    qp_r = random_qp_batch(1024, 32, 33, seed=0, device=dev)
    for name in ("kkt_ldlt", "schur_cholesky_tri"):
        st = qp_bench_settings(linear_solver=name)
        fn = functools.partial(qp_solve_batch, qp_r, st, impl="vmap")
        res, checks, wall = run(f"{name}_vmap", fn, {})
        m = aa_qp_metrics(qp_r, res, st)
        log(f"  {name} vmap one-shot n=32 m=33 B=1024: {wall * 1e3:.3f} ms "
            f"({1024 / wall:.1f} solves/s), solved {m['solved']:.4f}, f64 OSQP test (10x) "
            f"{m['f64']:.4f}, mean iter {m['mean_iter']:.1f}, host checks {checks} "
            f"[min of 3; {card}]")
        if m["solved"] < 0.99 or m["f64"] < 0.99:
            raise AssertionError(f"{name}: solved {m['solved']:.4f}, f64 test {m['f64']:.4f} "
                                 "(bars 0.99)")
        out[f"{name}_vmap"] = dict(ms=wall * 1e3, host_checks=checks, **m)

    # schur_cholesky_blocked on one SQP problem, n = 4096 (bench.py:455-470)
    nl = 4096
    sl = SQPSettings(max_iter=10, eps_prim=1e-3, eps_dual=1e-3, termination="kkt",
                     schedule="fixed", line_search_max_iter=8, polish=True,
                     qp=QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                                   check_termination=10, adaptive_rho=True,
                                   adaptive_rho_interval=50, schedule="fixed",
                                   linear_solver="schur_cholesky_blocked", refine_steps=1))
    prob, x0 = sphere_cap_nlp_batch(1, nl, seed=0, dtype=torch.float32, device=dev)
    fn = functools.partial(sqp_solve_batch, prob, x0, None, sl, impl="vmap")
    res, checks, wall = run("blocked_sqp_n4096", fn, dict(polish_kkt_launches=sl.polish_passes),
                            runs=1)
    x = res.x.cpu().numpy()
    err = float(np.abs(x.astype(np.float64) - sphere_cap_solution(prob)).max())
    cert = sphere_cert_1e4(prob.u[:, 0].double().cpu().numpy(), x, res.lam.cpu().numpy())
    status = int(res.info.status[0])
    log(f"  schur_cholesky_blocked SQP n={nl}: {wall * 1e3:.3f} ms, status {status}, "
        f"max |x - x*| {err:.3e}, f64 cert(1e-4) {cert:.4f}, host checks {checks} "
        f"[one run after a warm-up; {card}]")
    if not np.isfinite(x).all() or status != 0 or cert < 1.0:
        raise AssertionError(f"blocked SQP n={nl}: status {status}, cert {cert:.4f}")
    out["blocked_sqp_n4096"] = dict(ms=wall * 1e3, status=status, err=err, cert=cert,
                                    host_checks=checks)

    # the dense rows of bench.py:725-743: one QP, n = m = 4096, the dense
    # twin of sparse_qp_pair's (leg J solves its sparse twin)
    qp_d = sparse_qp_pair(4096, 4096, 128, 0.03, seed=0, device=dev)[0]
    qp_b = QuadraticProblem(*(v.unsqueeze(0) for v in (qp_d.P, qp_d.q, qp_d.A, qp_d.l, qp_d.u)))
    cg = sparse_cg_settings()
    for label, st in (("dense_cg", cg),
                      ("dense_chol_blocked", dataclasses.replace(
                          cg, linear_solver="schur_cholesky_blocked"))):
        fn = functools.partial(qp_solve, qp_d, st)
        res, checks, wall = run(label, fn, {}, runs=2)
        status = int(res.info.status)
        ok, _ = qp_osqp64(qp_b, types.SimpleNamespace(x=res.x[None], y=res.y[None]),
                          st.eps_abs, st.eps_rel)
        log(f"  {label} QP n=m=4096: {wall * 1e3:.3f} ms, status {status}, iter "
            f"{int(res.info.iter)}, f64 OSQP test (10x) {bool(ok[0])}, host checks {checks} "
            f"[min of 2; {card}]")
        if not torch.isfinite(res.x).all() or (status == 0 and not ok[0]):
            raise AssertionError(f"{label}: status {status}, f64 OSQP test {bool(ok[0])}")
        out[label] = dict(ms=wall * 1e3, status=status, iter=int(res.info.iter),
                          f64=bool(ok[0]), host_checks=checks)
    return dict(runs=out, counts=counts)


# ---- I-M. the last modules: arrow, sparse, multi-outer NLPs, the layers ------


def run_arrow(dev, card: str) -> dict:
    """Leg I (bench.py:644-711): the coupled MPC, 48 agents of horizon 16,
    B = 64 (n = 770, m = 1586, blocks of 16, a border of 2), 100 ADMM
    iterations with adaptive rho, on the dense backend (vmap tier) and on
    ``schur_arrow`` (vmap tier, and fused tier with the fixed schedule),
    no launch; walls min of 3, solved fraction, the float64 OSQP test of
    every SOLVED problem, and where both solved arrow's objective against
    dense's (1e-5 relative) and its x (10x the tolerance, 1e-2)."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.mpc import mpc_qp_coupled_batch
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp.types import QPSettings

    qp, blk, cw = mpc_qp_coupled_batch(64, agents=48, horizon=16, device=dev)
    n, m = qp.n, qp.m
    dense = QPSettings(adaptive_rho=True, max_iter=100)
    arrow = dataclasses.replace(dense, linear_solver="schur_arrow", block_size=blk,
                                arrow_width=cw)
    rows = (("dense_vmap", dense, "vmap"), ("arrow_vmap", arrow, "vmap"),
            ("arrow_fused", dataclasses.replace(arrow, schedule="fixed"), "fused"))
    out, counts, res = {}, {}, {}

    def objective(r):
        x = r.x.double()
        return (0.5 * (x * torch.einsum("bij,bj->bi", qp.P.double(), x)).sum(-1)
                + (qp.q.double() * x).sum(-1))

    for label, s, impl in rows:
        r, checks, wall = counted_run(f"coupled_{label}", functools.partial(
            qp_solve_batch, qp, s, impl=impl), {}, counts)
        met = aa_qp_metrics(qp, r, s)
        res[label] = r
        out[label] = dict(ms=wall * 1e3, host_checks=checks, **met)
        log(f"  coupled MPC {label} n={n} m={m} B=64: {wall * 1e3:.3f} ms, solved "
            f"{met['solved']:.4f}, f64 OSQP test (10x) {met['f64']:.4f}, mean iter "
            f"{met['mean_iter']:.1f}, host checks {checks} [min of 3; {card}]")
    d = res["dense_vmap"]
    for label in ("arrow_vmap", "arrow_fused"):
        both = (d.info.status == 0) & (res[label].info.status == 0)
        if int(both.sum()) == 0:
            raise AssertionError(f"{label}: no problem solved on both backends")
        fa, fd = objective(res[label])[both], objective(d)[both]
        rel = float(((fa - fd).abs() / (1.0 + fd.abs())).max())
        dx = float((res[label].x - d.x)[both].abs().max())
        log(f"  {label} against dense where both solved ({int(both.sum())} of 64): objective "
            f"{rel:.3e} relative, max |x - x_dense| {dx:.3e}")
        # two eps-solutions part in x by about eps (float32 iterates through two
        # factors), so x is held at the OSQP test's 10x the tolerance
        x_bar = 10.0 * max(dense.eps_abs, dense.eps_rel)
        if rel > 1e-5 or dx > x_bar:
            raise AssertionError(f"{label}: objective {rel:.3e} relative from dense's (bar "
                                 f"1e-5), max |x - x_dense| {dx:.3e} (bar {x_bar:.0e})")
        out[label].update(objective_rel=rel, x_diff=dx)
    return dict(runs=out, counts=counts, n=n, m=m)


def run_sparse(dev, card: str, backends_run: dict, crossover: bool = True) -> dict:
    """Leg J (bench.py:722-811): ``sparse_qp_pair(n = m = 4096, bs = 128,
    density 0.03)``'s BlockSparse twin through ``qp_solve`` on cg, beside
    leg H's dense cg and blocked Cholesky rows on its dense twin; then the
    crossover rows at n = m = 8192 (sparse cg at density 0.015 and 0.03,
    the blocked Cholesky once).  No launch; walls min of 2; status,
    iterations, host checks and the float64 OSQP test of a SOLVED result."""
    import dataclasses

    import torch

    from sqp_solver_tpu_torch.models.sparse import sparse_qp_pair
    from sqp_solver_tpu_torch.qp import qp_solve

    cg = sparse_cg_settings()
    out, counts = {}, {}

    def row(label, dense, prob, st):
        r, checks, wall = counted_run(label, functools.partial(qp_solve, prob, st), {}, counts,
                                      runs=2)
        status = int(r.info.status)
        qpb = types.SimpleNamespace(**{k: getattr(dense, k).unsqueeze(0) for k in LEAVES})
        ok, _ = qp_osqp64(qpb, types.SimpleNamespace(x=r.x[None], y=r.y[None]), st.eps_abs,
                          st.eps_rel)
        log(f"  {label} n=m={dense.n}: {wall * 1e3:.3f} ms, status {status}, iter "
            f"{int(r.info.iter)}, f64 OSQP test (10x) {bool(ok[0])}, host checks {checks} "
            f"[min of 2; {card}]")
        if not torch.isfinite(r.x).all() or (status == 0 and not ok[0]):
            raise AssertionError(f"{label}: status {status}, f64 OSQP test {bool(ok[0])}")
        out[label] = dict(ms=wall * 1e3, status=status, iter=int(r.info.iter), f64=bool(ok[0]),
                          host_checks=checks)
        return r

    dense, sparse = sparse_qp_pair(4096, 4096, 128, 0.03, seed=0, device=dev)
    row("sparse_cg_n4096", dense, sparse, cg)
    h = backends_run["runs"]
    log(f"  P {sparse.P.nblocks} of {(sparse.P.shape[0] // sparse.P.bs) ** 2} blocks, A "
        f"{sparse.A.nblocks}; beside dense cg "
        f"{h['dense_cg']['ms']:.3f} ms ({h['dense_cg']['iter']} iter) and dense blocked "
        f"Cholesky {h['dense_chol_blocked']['ms']:.3f} ms on its dense twin (leg H)")
    if crossover:
        for dens in (0.015, 0.03):
            d8, s8 = sparse_qp_pair(8192, 8192, 128, dens, seed=7, device=dev)
            row(f"sparse_cg_n8192_d{dens}", d8, s8, cg)
            if dens == 0.015:  # the dense baseline does not depend on the density
                row("dense_chol_blocked_n8192", d8, d8, dataclasses.replace(
                    cg, linear_solver="schur_cholesky_blocked"))
            del d8, s8
    return dict(runs=out, counts=counts)


MULTI_OUTER = {  # outers, polish passes, line-search steps, inner eps, inner iterations, eps
    "exp_chain": (36, 3, 6, 1e-4, 50, 1e-3),  # bench.py:1135-1145
    "rosenbrock": (300, 3, 16, 1e-5, 200, 1e-4),  # bench.py:1260-1270
    "sqp_diff": (24, 2, 6, 1e-4, 50, 1e-3),  # bench.py:1322-1332
}


def multi_outer_settings(leg: str):
    """The K1-tier settings of a multi-outer leg of :data:`MULTI_OUTER`."""
    from sqp_solver_tpu_torch.qp.types import QPSettings
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    outers, polish_passes, ls, qp_eps, qp_iter, eps = MULTI_OUTER[leg]
    return SQPSettings(max_iter=outers, eps_prim=eps, eps_dual=eps, termination="kkt",
                       schedule="fixed", qp_impl="kernel", polish=True,
                       polish_passes=polish_passes, line_search_max_iter=ls,
                       qp=QPSettings(alpha=1.6, eps_abs=qp_eps, eps_rel=qp_eps,
                                     max_iter=qp_iter, check_termination=10, warm_start=True,
                                     adaptive_rho=True, adaptive_rho_interval=50,
                                     schedule="fixed"))


def run_multi_outer(dev, card: str) -> dict:
    """Leg K: the exponential chain (bench.py:1123-1178: B = 1024, n = 32,
    36 fixed outers) and the ball-constrained Rosenbrock (bench.py:1248-1306:
    300 outers, inner QPs of 200 iterations, 16 line-search steps) on the
    K1 tier, drawn on the card (a fresh seed a run); walls min of 3, the
    solved fraction and the float64 KKT certificate at 1e-4 of
    ``*_kkt_residuals``, which must hold for >= 0.99 of SOLVED problems."""
    from sqp_solver_tpu_torch.models import benchmark as bm
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch

    rows = (("exp_chain", bm.exp_chain_nlp_batch_device, bm.exp_chain_kkt_residuals,
             multi_outer_settings("exp_chain")),
            ("rosenbrock", bm.rosenbrock_nlp_batch_device, bm.rosenbrock_kkt_residuals,
             multi_outer_settings("rosenbrock")))
    out, counts = {}, {}
    for label, gen, resid, s in rows:
        seeds = iter(range(1, 100))
        last = {}

        def fn(gen=gen, s=s, last=last, seeds=seeds):
            prob, x0 = gen(next(seeds), 1024, 32, device=dev)
            last["prob"], last["res"] = prob, sqp_solve_batch(prob, x0, None, s, impl="fused")
            return last["res"]

        want = dict(sqp_step_launches=s.max_iter, polish_kkt_launches=s.polish_passes)
        res, _, wall = counted_run(f"nlp_{label}", fn, want, counts)
        res, prob = last["res"], last["prob"]
        pv, dr = resid(prob, res.x, res.lam)
        solved = (res.info.status == 0).cpu().numpy()
        cert = (pv <= 1e-4) & (dr <= 1e-4)
        cert_solved = float(cert[solved].mean()) if solved.any() else 0.0
        it = res.info.iter.cpu().numpy()
        log(f"  {label} n=32 B=1024, {s.max_iter} outers: {wall * 1e3:.3f} ms ({1024 / wall:.1f} "
            f"solves/s), solved {solved.mean():.4f}, f64 KKT cert (1e-4) {cert.mean():.4f} of "
            f"all and {cert_solved:.4f} of SOLVED, outers p50 {np.percentile(it, 50):.0f} p99 "
            f"{np.percentile(it, 99):.0f}, stationarity p99 {np.percentile(dr, 99):.2e} "
            f"[min of 3; {card}]")
        if not np.isfinite(res.x.cpu().numpy()).all() or not solved.any() or cert_solved < 0.99:
            raise AssertionError(f"{label}: solved {solved.mean():.4f}, certified "
                                 f"{cert_solved:.4f} of SOLVED (bar 0.99)")
        out[label] = dict(ms=wall * 1e3, solved=float(solved.mean()), cert=float(cert.mean()),
                          cert_of_solved=cert_solved, outers_p50=float(np.percentile(it, 50)))
    return dict(runs=out, counts=counts)


def timed_backward(loss, walls: list) -> None:
    """``loss.backward()``, its wall seconds (closed by a synchronize)
    appended to ``walls``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)


def random_cotangent(x):
    """A seeded normal cotangent shaped as ``x`` (the legs' own losses,
    sums of x^2, give 2 x, which on the sphere-like families lies in the
    active constraints' span and leaves dz_x at rounding level)."""
    import torch

    g = np.random.default_rng(0).normal(size=tuple(x.shape))
    return torch.as_tensor(g, dtype=x.dtype, device=x.device)


def adjoint_routes(label: str, vjp, args_cuda, counts: dict) -> dict:
    """One backward pass by each adjoint route on a subset: K2
    (``use_kernel=None``), K4 (``use_kernel=False``), each launch counted,
    against the plain route on CPU copies; the largest difference of each
    gradient relative to its largest entry, <= 1e-3."""
    import torch

    def cpu(a):
        return a.cpu() if torch.is_tensor(a) else a

    outs = {}
    for route, counter in ((None, "polish_kkt_launches"), (False, "spd_inverse_launches")):
        reset_counts()
        outs[route] = vjp(*args_cuda, use_kernel=route)
        c = read_counts()
        if c != expect(**{counter: 1}):
            raise AssertionError(f"{label} adjoint route {route}: launches {c}")
        counts[f"{label}_adjoint_{counter.split('_')[0]}"] = c
    plain = vjp(*(cpu(a) for a in args_cuda))
    worst = {}
    for name, other in (("k2_vs_plain", outs[None]), ("k4_vs_plain", outs[False]),
                        ("k2_vs_k4", None)):
        pairs = zip(outs[None], outs[False]) if other is None else zip(other, plain)
        rel = 0.0
        for a, b in pairs:
            if a is None:
                continue
            a, b = a.cpu().double(), b.cpu().double()
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"{label} {name}: a gradient is not finite")
            rel = max(rel, float((a - b).abs().max() / (1e-12 + b.abs().max())))
        worst[name] = rel
    log(f"  {label} adjoint routes on the subset: " + ", ".join(
        f"{k} {v:.2e}" for k, v in worst.items()) + " (largest difference over the largest "
        "entry)")
    if max(worst.values()) > 1e-3:
        raise AssertionError(f"{label}: adjoint routes differ: {worst}")
    return worst


def run_qp_diff(dev, card: str) -> dict:
    """Leg L (bench.py:1179-1247): ``qp_solve_diff`` on
    ``random_qp_batch_device`` B = 1024, n = m = 128, the fused tier, 200
    iterations, polish, the fixed schedule: forward wall (8 K5 and 2 K2
    launches) and forward + backward wall (one more K2: the adjoint),
    min of 3, and the backward alone, the gradients to P, q, A, l and u
    finite; then the adjoint routes on 64 problems."""
    import torch

    from sqp_solver_tpu_torch.models.families import random_qp_batch_device
    from sqp_solver_tpu_torch.qp.diff import qp_solve_diff, qp_solve_vjp
    from sqp_solver_tpu_torch.qp.types import QPSettings, QuadraticProblem

    s = QPSettings(alpha=1.6, eps_abs=1e-5, eps_rel=1e-5, max_iter=200, check_termination=25,
                   adaptive_rho=True, adaptive_rho_interval=50, polish=True, schedule="fixed")
    counts, seeds, last, bwd = {}, iter(range(1, 100)), {}, []

    def fwd():
        qp = random_qp_batch_device(next(seeds), 1024, 128, 128, device=dev)
        x = qp_solve_diff(qp, s, "fused")
        return (x * x).sum()

    def fwd_bwd():
        qp = random_qp_batch_device(next(seeds), 1024, 128, 128, device=dev)
        leaves = {k: getattr(qp, k).requires_grad_(True) for k in LEAVES}
        x = qp_solve_diff(QuadraticProblem(**leaves), s, "fused")
        timed_backward((x * x).sum(), bwd)
        last["qp"] = qp
        return sum(leaves[k].grad.abs().sum() for k in LEAVES)

    chunks = -(-s.max_iter // s.check_termination)
    _, _, t_f = counted_run("qp_diff_forward", fwd, dict(
        admm_chunk_launches=chunks, polish_kkt_launches=s.polish_passes), counts)
    gsum, _, t_b = counted_run("qp_diff_backward", fwd_bwd, dict(
        admm_chunk_launches=chunks, polish_kkt_launches=s.polish_passes + 1), counts)
    gsum = float(gsum)
    if not np.isfinite(gsum) or gsum == 0.0:
        raise AssertionError(f"qp_solve_diff: gradient magnitude sum {gsum}")
    # the adjoint routes at one solution, 64 problems
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    sub = QuadraticProblem(*(getattr(last["qp"], k).detach()[:64].contiguous()
                             for k in LEAVES))
    res = qp_solve_batch(sub, s, impl="fused")
    g = random_cotangent(res.x)
    solved = float((res.info.status == 0).float().mean())
    routes = adjoint_routes("qp_diff", lambda *a, **kw: qp_solve_vjp(*a, s, **kw), (
        sub.P, sub.A, sub.l, sub.u, res.x, res.y, res.info.status, g), counts)
    log(f"  qp_solve_diff B=1024 n=m=128 fused: forward {t_f * 1e3:.3f} ms, forward + backward "
        f"{t_b * 1e3:.3f} ms, the backward alone {min(bwd) * 1e3:.3f} ms, gradient magnitude "
        f"sum {gsum:.4e} (finite); subset solved {solved:.4f} [min of 3; {card}]")
    return dict(runs=dict(forward_ms=t_f * 1e3, forward_backward_ms=t_b * 1e3,
                          backward_ms=min(bwd) * 1e3, gsum=gsum, subset_solved=solved,
                          routes=routes), counts=counts)


def run_sqp_diff(dev, card: str) -> dict:
    """Leg M (bench.py:1307-1382): ``sqp_solve_diff`` on the exponential
    chain, B = 1024, n = 32, 24 outers on the K1 tier, polish 2: forward
    wall (24 K1, 2 K2) and forward + backward wall (one more K2), min of 3,
    and the backward alone, the gradients to l, u and params finite; then
    the adjoint routes on 64 problems."""
    from sqp_solver_tpu_torch.models.benchmark import exp_chain_nlp_batch_device
    from sqp_solver_tpu_torch.sqp.diff import sqp_solve_diff, sqp_solve_vjp

    s = multi_outer_settings("sqp_diff")
    counts, seeds, last, bwd = {}, iter(range(1, 100)), {}, []

    def fwd():
        prob, x0 = exp_chain_nlp_batch_device(next(seeds), 1024, 32, device=dev)
        return (sqp_solve_diff(prob, x0, None, s, "fused") ** 2).sum()

    def fwd_bwd():
        prob, x0 = exp_chain_nlp_batch_device(next(seeds), 1024, 32, device=dev)
        leaves = [t.requires_grad_(True) for t in (prob.l, prob.u, prob.params)]
        x = sqp_solve_diff(prob, x0, None, s, "fused")
        timed_backward((x * x).sum(), bwd)
        last["prob"], last["x0"] = prob, x0
        return sum(t.grad.abs().sum() for t in leaves)

    want = dict(sqp_step_launches=s.max_iter, polish_kkt_launches=s.polish_passes)
    _, _, t_f = counted_run("sqp_diff_forward", fwd, want, counts)
    want["polish_kkt_launches"] += 1
    gsum, _, t_b = counted_run("sqp_diff_backward", fwd_bwd, want, counts)
    gsum = float(gsum)
    if not np.isfinite(gsum) or gsum == 0.0:
        raise AssertionError(f"sqp_solve_diff: gradient magnitude sum {gsum}")
    import dataclasses

    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch

    p = last["prob"]
    sub = dataclasses.replace(p, l=p.l.detach()[:64], u=p.u.detach()[:64],
                              params=p.params.detach()[:64])
    res = sqp_solve_batch(sub, last["x0"][:64], None, s, impl="fused")
    solved = float((res.info.status == 0).float().mean())

    def vjp(x, lam, status, g, l, u, params, use_kernel=None):
        prob = dataclasses.replace(sub, l=l, u=u, params=params)
        return sqp_solve_vjp(prob, x, lam, status, g, s, use_kernel=use_kernel)

    routes = adjoint_routes("sqp_diff", vjp, (res.x, res.lam, res.info.status,
                                              random_cotangent(res.x),
                                              sub.l, sub.u, sub.params), counts)
    log(f"  sqp_solve_diff exp-chain B=1024 n=32, 24 outers (K1): forward {t_f * 1e3:.3f} ms, "
        f"forward + backward {t_b * 1e3:.3f} ms, the backward alone {min(bwd) * 1e3:.3f} ms, "
        f"gradient magnitude sum over l, u, params {gsum:.4e} (finite); subset solved "
        f"{solved:.4f} [min of 3; {card}]")
    return dict(runs=dict(forward_ms=t_f * 1e3, forward_backward_ms=t_b * 1e3,
                          backward_ms=min(bwd) * 1e3, gsum=gsum, subset_solved=solved,
                          routes=routes), counts=counts)


def run_sharding(dev, card: str) -> dict:
    """The batch split over ``make_mesh()`` (every card; one here):
    ``sharded_qp_solve_batch`` through K3 on the one-shot QP and
    ``sharded_sqp_solve_batch`` on the K1 tier's n = 32 cell, each equal
    to the unsharded call bit for bit, with the unsharded call's
    launches."""
    import torch

    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch
    from sqp_solver_tpu_torch.models.mpc import random_qp_batch
    from sqp_solver_tpu_torch.parallel import (
        make_mesh,
        qp_solve_batch,
        sharded_qp_solve_batch,
        sharded_sqp_solve_batch,
        sqp_solve_batch,
    )

    mesh = make_mesh()
    qp = random_qp_batch(4096, 32, 33, seed=0, device=dev)
    prob, x0 = sphere_cap_nlp_batch(4096, 32, seed=3, device=dev)
    qs, ss = qp_bench_settings(), bench_settings(32)
    counts = {}
    pairs = (("qp_k3", lambda: qp_solve_batch(qp, qs, impl="kernel"),
              lambda: sharded_qp_solve_batch(qp, qs, mesh, impl="kernel"),
              dict(qp_solve_launches=1)),
             ("sqp_k1", lambda: sqp_solve_batch(prob, x0, None, ss, impl="fused"),
              lambda: sharded_sqp_solve_batch(prob, x0, None, ss, mesh, impl="fused"),
              dict(sqp_step_launches=ss.max_iter, polish_kkt_launches=ss.polish_passes)))
    for label, plain, sharded, want in pairs:
        a, _, t_a = counted_run(f"sharding_{label}_unsharded", plain, want, counts, runs=1)
        b, _, t_b = counted_run(f"sharding_{label}_sharded", sharded, want, counts, runs=1)
        if not (torch.equal(a.x, b.x) and torch.equal(a.info.status, b.info.status)):
            raise AssertionError(f"sharding {label}: the sharded result differs")
        log(f"  sharded {label} over {len(mesh)} device(s): equal to unsharded bit for bit "
            f"({t_b * 1e3:.3f} ms against {t_a * 1e3:.3f} ms) [{card}]")
    return dict(counts=counts, devices=len(mesh))


def k5_routes(rows: list, fused_mid_run: dict) -> dict:
    """K5's routes for the kernels line: each route's kernel (all in
    ``K5_CU_SOURCE``), the shapes of the kernel phase that took it with
    their ms, plain ms, bound and share of the streaming floor, and leg Q's
    launches on it."""
    kernels = dict(narrow="admm_chunk_kernel", cluster="admm_chunk_cluster_kernel",
                   stream="admm_chunk_wide_kernel (admm_chunk_wide_xl_kernel past D = 2048)")
    out = {}
    for route, kernel in kernels.items():
        shapes = [dict(n=r["n"], m=r["m"], batch=r["batch"], seg=r["seg"], ms=r["ms"],
                       plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                       stream_share=r["stream_share"], cluster=r["cluster"],
                       w_bytes_per_iteration=r["w_bytes_per_iteration"])
                  for r in rows if r["route"] == route]
        leg_q = sum(run["routes"][route] for run in fused_mid_run["runs"].values())
        out[route] = dict(kernel=kernel, source=K5_CU_SOURCE, shapes=shapes,
                          leg_q_launches=leg_q)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: torch is not installed ({exc})")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    if not os.path.isdir(os.path.join(ROOT, "sqp_solver_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout (sqp_solver_tpu_torch/ missing)")
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)

    # 1. device facts
    card = card_line()
    log(f"card: {card}")
    from sqp_solver_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")

    # 2. build

    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from sqp_solver_tpu_torch.tools import kernel_ab

    # the Anderson units with the units they include: K1-K4, the structured
    # kernel and the wide one with and without Anderson in one library each
    phase_sources = ("qp_kernel_aa.cu", "admm_kernel.cu", "qp_kernel_btd_aa.cu",
                     "qp_kernel_btd_wide_aa.cu")
    with ThreadPoolExecutor(len(phase_sources)) as pool:  # with phase clocks, meanwhile
        phase_builds = {src: pool.submit(kernel_ab.phase_library, kernel_ab.ROOT,
                                         f"smoke-{src.split('.')[0]}", src)
                        for src in phase_sources}
        _build.load()
        phase_libs = {src: f.result() for src, f in phase_builds.items()}
    phase_libs.update({kernel_ab.TWINS[src]: phase_libs[src] for src in phase_sources
                       if src in kernel_ab.TWINS})
    units = ", ".join(f"{k} {v:.1f} s" for k, v in _build.last_unit_seconds.items())
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.last_build_seconds:.2f} s: "
        f"{units}) into {_build.build_dir()}, with the phase-clock builds of K1-K5 and the "
        "wide K6/K7, each with its Anderson instantiations")

    # 3. each kernel against its plain version at its paths' shapes
    log("kernels against their plain versions (float32, atol = rtol = 1e-4; with rho epochs "
        "or equality rows, float32 kernel and plain each against plain float64 at "
        f"{EPOCH_TOL}):")
    k1 = [compare_step(4096, 32, dev, reps=20), compare_step(1024, 128, dev, reps=8)]
    k2 = [compare_polish(4096, 32, 6, dev, reps=20), compare_polish(1024, 128, 4, dev, reps=8),
          compare_polish_reuse(1024, 128, 4, dev, reps=8)]
    k3 = [compare_qp("random", 4096, 32, dev, reps=10), compare_qp("mpc", 4096, 16, dev, reps=10)]
    compare_certificates(dev)
    k4 = [compare_spd(4096, 32, dev, reps=20), compare_spd(1024, 128, dev, reps=8)]
    k5 = [compare_chunk(4096, 32, 33, 10, dev, reps=20),
          compare_chunk(4096, 32, 33, 25, dev, reps=20),
          compare_chunk(4096, 16, 32, 25, dev, reps=20),
          compare_chunk(1024, 128, 129, 10, dev, reps=8),
          compare_chunk(256, 640, 640, 10, dev, reps=4),
          compare_chunk(64, 1024, 1024, 10, dev, reps=4)]
    log("K5 at the middle sizes (D = 289-1024: the cluster and stream routes) and at the JAX "
        "kernel's limit (D = 2125):")
    k5 += [compare_chunk(*shape, dev, reps=4) for shape in CHUNK_MID_SHAPES]
    k5.append(compare_chunk(64, 1062, 1063, 10, dev, reps=3))
    log("K1-K5 phase split (clock64 spans of thread 0, cycles per block, share of the total):")
    phases = phase_split(dev, phase_libs, card)
    factor_ms = [time_library_factor(4096, 32, 33, dev, reps=10),
                 time_library_factor(1024, 128, 129, dev, reps=5)]
    random, mpc256, mpc4096, step32, step48 = btd_cases(dev)
    k6 = [compare_btd_random(random, reps=5), compare_btd_f64(mpc256, reps=10),
          compare_btd_f64(mpc4096, reps=5)]
    k7 = [compare_btd_f64(step32, reps=10), compare_btd_f64(step48, reps=10)]
    control, rand64, rand128, mixed, wpath, wstep = btd_wide_cases(dev)
    k6w = [compare_control(control, reps=2), compare_btd_random(rand64, reps=3),
           compare_btd_random(rand128, reps=3), compare_btd_mixed(mixed, reps=3)]
    k7w = [compare_btd_random(wpath, reps=5), compare_btd_random(wstep, reps=3)]
    log("wide K6/K7 past internal block 128 (the compact route: A by its nonzeros, the "
        "rule's cluster):")
    for c in btd_past128_cases(dev):
        (k6w if c["label"].startswith("K6") else k7w).append(
            compare_btd_past128(c, reps=2 if c["bb"] > 136 else 3))
    log("wide K6/K7 phase split (clock64 spans of thread 0, cycles per block):")
    wide_phases = wide_phase_split(phase_libs["qp_kernel_btd_wide.cu"],
                                   [control, wpath, wstep, btd_control50_case(16, dev)], card)
    # the wide kernel with Anderson, chunks of 10 (a ring of several pairs),
    # against float64 as in leg G; the plain float32 version itself parts
    # from float64 by ~1e-3 here, so relative to it
    k6w_aa = compare_aa(
        f"{rand64['label']} bb=64, chunks of 10", rand64["t"],
        lambda t, st: btd_launch(t, st, True), lambda t, st: btd_plain(t, st, True),
        dataclasses.replace(rand64["settings"], check_termination=10),
        lambda out, st: btd_bound(out, st, rand64["batch"], rand64["n"], rand64["m"], 64,
                                  A=rand64["t"]["J"]),
        reps=3, pairs=True, relative=True,
        dense_bound_of=lambda out, st: btd_bound(out, st, rand64["batch"], rand64["n"],
                                                 rand64["m"], 64))
    for name, rows in (("sqp_step", k1), ("polish_kkt", k2), ("qp_solve", k3),
                       ("spd_inverse", k4), ("admm_chunk", k5), ("qp_solve_btd", k6),
                       ("btd_step", k7), ("qp_solve_btd_wide", k6w),
                       ("btd_step_wide", k7w)):
        for r in rows:
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
            if "library_spread" in r:
                lib += " (median of turns, spread {:.3f}-{:.3f})".format(*r["library_spread"])
            seg = f" seg={r['seg']}" if "seg" in r else ""
            seg += f" {r['family']}" if "bb" in r else ""
            dense = ""
            if "bound_dense_ms" in r:
                dense = (f" on A's nonzeros, {r['bound_dense_ms']:.4f} ms "
                         f"({r['bound_dense_by']}) on dense A")
            log(f"  {name} n={r['n']} B={r['batch']}{seg}: kernel {r['ms']:.3f} ms, "
                f"plain {r['plain_ms']:.3f} ms{lib}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}){dense} [{card}]")

    # 4.-7. the paths end to end, each with the launch counters from 0
    configs = [(32, 4096), (128, 1024)]
    log("SQP main path: sqp_solve_batch(impl='fused') on the sphere-cap family:")
    main_run = run_main_path(configs, dev, card)
    fused_run = run_main_path(configs, dev, card, qp_impl="fused")
    log("one-shot QP serving: qp_solve_batch(impl='kernel') and (impl='fused'):")
    qp_run = run_qp_one_shot(dev, card)
    qp_fused_run = run_qp_one_shot(dev, card, impl="fused")
    infeas_run = run_infeasible_fused(dev)
    log("sustained MPC serving: qp_solve_sequence, impl='kernel' and 'fused':")
    mpc_run = run_mpc_sequence(dev, card)
    mpc_fused_run = run_mpc_sequence(dev, card, impl="fused")
    log("sustained NLP serving: sqp_solve_sequence:")
    nlp_run = run_nlp_sequence(dev, card)
    log("structured MPC QP: qp_solve_batch(impl='kernel', linear_solver="
        "'schur_block_tridiag') against the dense K3:")
    btd_mpc_run = run_btd_mpc(dev, card)
    log("structured NLP: sqp_solve_batch(qp_impl='kernel_btd') against the dense kernel tier:")
    btd_nlp_run = run_btd_nlp(dev, card)

    # 10.-14. the reference-semantics tier (impl="vmap") and scaling
    leg_s = {}
    t_leg = time.perf_counter()
    log("A. one-shot QP serving on the vmap tier: qp_solve_batch(impl='vmap'):")
    qp_vmap_run = run_qp_one_shot(dev, card, impl="vmap")
    leg_s["A"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("B. SQP on the vmap tier: sqp_solve_batch(impl='vmap') on the sphere-cap family:")
    vmap_run = run_main_path(configs, dev, card, impl="vmap")
    leg_s["B"] = time.perf_counter() - t_leg
    # C ran inside the structured MPC leg (run_btd_mpc's dense vmap row)
    leg_s["C"] = btd_mpc_run["runs"][256]["vmap_seconds"]
    t_leg = time.perf_counter()
    log("D. sustained MPC serving on the vmap tier: qp_solve_sequence(impl='vmap'):")
    mpc_vmap_run = run_mpc_sequence(dev, card, impl="vmap")
    leg_s["D"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("E. the OSQP families under Ruiz scaling: qp_solve_batch(scaling=10):")
    families_run = run_families(dev, card)
    leg_s["E"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("F. the K1 SQP tier under inner-QP scaling (qp.scaling=10, K1 with do_bfgs=False):")
    scaled_run = run_main_path([(32, 4096)], dev, card, qp_impl="kernel", scaling=10)
    leg_s["F"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("G. Anderson acceleration inside the whole-solve kernels (K3, K1, K6, K7), each "
        "beside the same call without it:")
    aa_run = run_anderson(dev, card, main_run)
    log("G. the Anderson step's placement and split a chunk (the phase-clock builds of the "
        "Anderson units):")
    aa_run["placement"] = aa_report(dev, phase_libs, card)
    log(f"G. the Anderson kernels past memory 32: memory {AA_LONG_MEMORY}, chunks of 2, the "
        "ring filling and wrapping:")
    aa_run["long"] = run_anderson_long(dev, card, phase_libs)
    leg_s["G"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("H. the linear-solver backends at the JAX bench's shapes:")
    backends_run = run_backends(dev, card, btd_mpc_run)
    leg_s["H"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("I. schur_arrow on the coupled MPC (vmap and fused tiers) beside the dense backend:")
    arrow_run = run_arrow(dev, card)
    leg_s["I"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("J. BlockSparse operands on cg: qp_solve(sparse_qp_pair), and the n = 8192 crossover:")
    sparse_run = run_sparse(dev, card, backends_run)
    leg_s["J"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("K. the multi-outer NLPs on the K1 tier (exp-chain, Rosenbrock):")
    multi_run = run_multi_outer(dev, card)
    leg_s["K"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("L. the differentiable QP layer: qp_solve_diff on the fused tier, forward and backward:")
    qp_diff_run = run_qp_diff(dev, card)
    leg_s["L"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("M. the differentiable NLP layer: sqp_solve_diff on the K1 tier, forward and backward:")
    sqp_diff_run = run_sqp_diff(dev, card)
    leg_s["M"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("N. the control arm (OSQP control class, 6-DOF arm) through qp_solve_batch(impl="
        "'kernel', block_size=18): the wide structured kernel end to end:")
    control_run = run_control_arm(dev, card)
    leg_s["N"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("P. the OSQP control class at 50 states (nx = 50, nu = 25, horizon 10) through "
        "qp_solve_batch(impl='kernel', block_size=75): the wide kernel past internal block 128:")
    control50_run = run_control50(dev, card)
    k6w.append(control50_run["row"])
    leg_s["P"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("O. the fused tier past D = 1024: qp_solve_batch(impl='fused') at n = m = 640:")
    fused_wide_run = run_fused_wide(dev, card)
    leg_s["O"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("Q. the fused tier at the middle sizes: qp_solve_batch(impl='fused') at n = m = 256 "
        "and on the control class at 12 states (n = 360, m = 600), K5's cluster and stream "
        "routes:")
    fused_mid_run = run_fused_mid(dev, card)
    leg_s["Q"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    log("the batch split: sharded_qp_solve_batch and sharded_sqp_solve_batch over make_mesh():")
    shard_run = run_sharding(dev, card)
    leg_s["sharding"] = time.perf_counter() - t_leg
    log("legs' seconds: " + ", ".join(f"{k} {v:.1f} s" for k, v in leg_s.items())
        + f", {sum(leg_s.values()):.1f} s in all (C ran inside the structured MPC leg)")
    paths = dict(
        **{f"sqp_main_n{n}": c for n, c in main_run["launches"].items()},
        **{f"sqp_fused_n{n}": c for n, c in fused_run["launches"].items()},
        nlp_sustained=nlp_run["counts"], mpc_sustained=mpc_run["counts"],
        mpc_sustained_fused=mpc_fused_run["counts"], qp_fused_certificates=infeas_run["counts"],
        **{f"qp_one_shot_{k}": v["counts"] for k, v in qp_run["runs"].items()},
        **{f"qp_fused_one_shot_{k}": v["counts"] for k, v in qp_fused_run["runs"].items()},
        **btd_mpc_run["counts"], **btd_nlp_run["counts"],
        **{f"qp_vmap_one_shot_{k}": v["counts"] for k, v in qp_vmap_run["runs"].items()},
        **{f"sqp_vmap_n{n}": c for n, c in vmap_run["launches"].items()},
        mpc_sustained_vmap=mpc_vmap_run["counts"], **families_run["counts"],
        **{f"sqp_scaled_n{n}": c for n, c in scaled_run["launches"].items()},
        **aa_run["counts"], **backends_run["counts"], **arrow_run["counts"],
        **sparse_run["counts"], **multi_run["counts"], **qp_diff_run["counts"],
        **sqp_diff_run["counts"], **shard_run["counts"], **control_run["counts"],
        **fused_wide_run["counts"], **control50_run["counts"], **fused_mid_run["counts"])

    def entry(name, replaces, rows, source=CU_SOURCE, **extra):
        head = rows[0]
        counter = f"{name}_launches"
        by_path = {p: c[counter] for p, c in paths.items() if c[counter]}
        if not by_path:
            raise AssertionError(f"{name}: no path run launched it")
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()),
            max_abs_err=max(max(r["max_abs_err"], r.get("other_max_abs_err", 0.0)) for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            launches_by_path=by_path, shape=dict(n=head["n"], batch=head["batch"]),
            by_shape=rows, **extra,
        )

    no_lib = "none: no single PyTorch call computes a whole block-tridiagonal ADMM solve"
    k1_lib = ("none: no single PyTorch call computes a BFGS update, a Schur factor and a "
              "whole warm-started ADMM solve")
    k2_lib = ("none: no single PyTorch call computes a Schur factor's L^-1 and the "
              "refinement sweeps of an active-set KKT solve")
    aa = aa_run["rows"]  # each whole-solve kernel's row with Anderson (leg G)
    aa_long = aa_run["long"]["timed"]  # each Anderson kernel at memory 40 beside memory 4
    kernels = [entry("sqp_step", K1_SOURCE, k1, library_note=k1_lib, anderson=aa["sqp_step"],
                     anderson_memory40=aa_long["sqp_step"]),
               entry("polish_kkt", K2_SOURCE, k2, library_note=k2_lib),
               entry("qp_solve", K3_SOURCE, k3, anderson=aa["qp_solve"],
                     anderson_memory40=aa_long["qp_solve"]),
               entry("spd_inverse", K4_SOURCE, k4),
               entry("admm_chunk", K5_SOURCE, k5, source=K5_CU_SOURCE,
                     routes=k5_routes(k5, fused_mid_run)),
               entry("qp_solve_btd", K6_SOURCE, k6, source=BTD_CU_SOURCE, library_note=no_lib,
                     anderson=aa["qp_solve_btd"], anderson_overhead=aa["qp_solve_btd_overhead"],
                     anderson_memory40=aa_long["qp_solve_btd"]),
               entry("btd_step", K7_SOURCE, k7, source=BTD_CU_SOURCE, library_note=no_lib,
                     anderson=aa["btd_step"], anderson_overhead=aa["btd_step_overhead"],
                     anderson_memory40=aa_long["btd_step"]),
               entry("qp_solve_btd_wide", K6_SOURCE, k6w, source=BTD_WIDE_CU_SOURCE,
                     library_note=no_lib, anderson=k6w_aa,
                     anderson_memory40=aa_long["qp_solve_btd_wide"]),
               entry("btd_step_wide", K7_SOURCE, k7w, source=BTD_WIDE_CU_SOURCE,
                     library_note=no_lib, anderson_memory40=aa_long["btd_step_wide"])]
    log(json.dumps(dict(main_path=main_run["configs"], fused_main_path=fused_run["configs"],
                        phases=phases, wide_phases=wide_phases,
                        library_factor=factor_ms,
                        qp_one_shot=qp_run, qp_fused_one_shot=qp_fused_run,
                        qp_fused_certificates=infeas_run, mpc_sustained=mpc_run,
                        mpc_sustained_fused=mpc_fused_run, nlp_sustained=nlp_run,
                        btd_mpc=btd_mpc_run, btd_nlp=btd_nlp_run,
                        qp_vmap_one_shot=qp_vmap_run, vmap_main_path=vmap_run["configs"],
                        mpc_sustained_vmap=mpc_vmap_run, families=families_run,
                        scaled_main_path=scaled_run["configs"], anderson=aa_run["runs"],
                        backends=backends_run["runs"], arrow=arrow_run["runs"],
                        sparse=sparse_run["runs"], multi_outer=multi_run["runs"],
                        qp_diff=qp_diff_run["runs"], sqp_diff=sqp_diff_run["runs"],
                        control_arm=control_run["runs"], fused_wide=fused_wide_run["runs"],
                        control50=control50_run["runs"], fused_mid=fused_mid_run["runs"],
                        anderson_long=aa_run["long"]["rows"],
                        legs_seconds=leg_s,
                        card=card)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
