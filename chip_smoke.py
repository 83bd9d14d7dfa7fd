#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device facts: ``nvidia-smi`` name and power limit, torch, CUDA, nvcc;
2. build the two CUDA kernels of the main path from ``sqp_solver_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, in float32,
   at the main path's shapes (n = 32, B = 4096 and n = 128, B = 1024),
   with both times from CUDA events;
4. the main path end to end, ``sqp_solve_batch(impl="fused")`` on the
   sphere-cap family at the two benchmark configurations, checked against
   the closed-form optimum and an independent float64 KKT certificate,
   with the kernels' launch counts asserted.

The line before the last two is ``{"kernels": [...]}``; then the card's
``name, power.limit``; the last line is ``{"ok": true, "device": ...}``.
The port's package is imported from the directory of this script; no
JAX is used.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "sqp_solver_tpu/ops/qp_kernel.py:1481"
K2_SOURCE = "sqp_solver_tpu/ops/qp_kernel.py:709"
CU_SOURCE = "sqp_solver_tpu_torch/csrc/qp_kernel.cu"
TOL = 1e-4  # atol = rtol for float32 kernel vs float32 plain version


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


def main_qp_settings():
    from sqp_solver_tpu_torch.qp.types import QPSettings

    # the inner-QP settings of both benchmark configurations (bench.py:222-232)
    return QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                      check_termination=10, warm_start=True, adaptive_rho=True,
                      adaptive_rho_interval=50, schedule="fixed")


def bench_settings(n: int):
    """The benchmark configurations: bench.py:209-233 (n = 32) and
    bench.py:352-369 (n = 128)."""
    from sqp_solver_tpu_torch.sqp.types import SQPSettings

    common = dict(eps_prim=2e-3, eps_dual=2e-3, termination="kkt", schedule="fixed",
                  qp_impl="kernel", polish=True, line_search_max_iter=5,
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


def compare_step(batch: int, n: int, dev, reps: int) -> dict:
    """K1 against its plain version: do_bfgs on and off, then the SOC pair
    (want_minv, then minv_in with shifted bounds)."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.testing import step_inputs

    s = main_qp_settings()
    t = to_device(step_inputs(batch, n, n + 1, seed=n, dtype=np.float32,
                              equality_row=False), dev)

    def call(fn, tt, **kw):
        return fn(tt["B"], tt["J"], tt["g"], tt["l"], tt["u"], tt["s"], tt["dgl"],
                  tt["reset"], tt["upd"], tt["active"], tt["x"], tt["z"], tt["y"], s, **kw)

    errs = []
    cases = [("do_bfgs=True", t, dict(do_bfgs=True, want_minv=True)),
             ("do_bfgs=False", t, dict(do_bfgs=False, want_minv=True))]
    first = call(qk.sqp_step_kernel, t, want_minv=True)
    t2 = dict(t, B=first.B, l=(t["l"] - 0.01).contiguous(), u=(t["u"] - 0.01).contiguous(),
              x=first.p, z=first.z, y=first.y)
    cases.append(("minv_in", t2, dict(do_bfgs=False, rho_in=first.rho_factor,
                                      minv_in=first.minv)))
    for label, tt, kw in cases:
        ok = call(qk.sqp_step_kernel, tt, **kw)
        ref = call(qk.sqp_step_reference, tt, **kw)
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
    ms = cuda_ms(lambda: call(qk.sqp_step_kernel, t), reps)
    plain_ms = cuda_ms(lambda: call(qk.sqp_step_reference, t), max(1, reps // 4))
    return dict(n=n, batch=batch, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def compare_polish(batch: int, n: int, sweeps: int, dev, reps: int) -> dict:
    """K2 against its plain version, with an indefinite H on problem 0."""
    import torch

    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.testing import polish_inputs

    t = to_device(polish_inputs(batch, n, n + 1, seed=n, dtype=np.float32), dev)
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
    return dict(n=n, batch=batch, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def sphere_cert_1e4(problem, x, lam) -> float:
    """Independent float64 KKT certificate of a sphere-cap batch at the
    reference's own tolerance 1e-4 (the numpy twin of bench.py:155): exact
    stationarity -1 + 2 lam_0 x + lam_rest and feasibility of
    ||x||^2 <= r^2, 0 <= x <= 1, with no solver code on the path."""
    xs = np.asarray(x, np.float64)
    lm = np.asarray(lam, np.float64)
    r2 = problem.u[:, 0].double().cpu().numpy()
    st = -1.0 + 2.0 * lm[:, 0:1] * xs + lm[:, 1:]
    dr = np.abs(st).max(axis=1)
    pv = np.maximum(np.sum(xs * xs, axis=1) - r2, 0.0)
    pv = np.maximum(pv, np.maximum(xs - 1.0, -xs).max(axis=1))
    return float(np.mean((dr <= 1e-4) & (pv <= 1e-4)))


def run_main_path(configs, dev, card: str) -> dict:
    """Both configurations end to end, launch counts asserted."""
    import torch

    from sqp_solver_tpu_torch.models.benchmark import sphere_cap_nlp_batch, sphere_cap_solution
    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch
    from sqp_solver_tpu_torch.sqp.types import SQPStatus

    def solve(n, batch, seed):
        problem, x0 = sphere_cap_nlp_batch(batch, n, seed=seed, dtype=torch.float32,
                                           device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sqp_solve_batch(problem, x0, None, bench_settings(n), impl="fused")
        torch.cuda.synchronize()
        return problem, res, time.perf_counter() - t0

    for n, batch in configs:  # warm-up: torch.func tracing, allocator
        solve(n, batch, seed=100)
    qk.sqp_step_launches = 0
    qk.polish_kkt_launches = 0
    results = {}
    for n, batch in configs:
        k1, k2 = qk.sqp_step_launches, qk.polish_kkt_launches
        problem, res, wall = solve(n, batch, seed=3)
        s = bench_settings(n)
        d1, d2 = qk.sqp_step_launches - k1, qk.polish_kkt_launches - k2
        if (d1, d2) != (s.max_iter, s.polish_passes):
            raise AssertionError(f"n={n}: kernel launches K1 {d1}, K2 {d2}; expected "
                                 f"{s.max_iter} and {s.polish_passes}")
        results[(n, batch)] = (problem, res, wall)
    launches = dict(sqp_step=qk.sqp_step_launches, polish_kkt=qk.polish_kkt_launches)

    summary = {}
    for (n, batch), (problem, res, wall) in results.items():
        status = res.info.status.cpu().numpy()
        x = res.x.cpu().numpy()
        lam = res.lam.cpu().numpy()
        if x.shape != (batch, n) or not np.isfinite(x).all() or not np.isfinite(lam).all():
            raise AssertionError(f"n={n}: solution has the wrong shape or is not finite")
        solved = float(np.mean(status == SQPStatus.SOLVED))
        err_p99 = float(np.percentile(np.abs(x.astype(np.float64) - sphere_cap_solution(problem)), 99))
        cert = sphere_cert_1e4(problem, x, lam)
        times = [wall] + [solve(n, batch, seed=10 + r)[2] for r in range(3)]
        t = min(times)
        log(f"  n={n} B={batch}: solved {solved:.4f}, err_p99 {err_p99:.3e}, "
            f"f64 cert(1e-4) {cert:.4f}, wall {t * 1e3:.3f} ms per batch "
            f"({t / batch * 1e6:.3f} us per solve, {batch / t:.1f} solves/s) "
            f"[min of {len(times)}; {card}]")
        if solved < 0.99:
            raise AssertionError(f"n={n}: solved fraction {solved:.4f} < 0.99")
        if err_p99 > 1e-6:
            raise AssertionError(f"n={n}: err_p99 {err_p99:.3e} > 1e-6")
        if cert < 0.99:
            raise AssertionError(f"n={n}: f64 certificate {cert:.4f} < 0.99")
        summary[n] = dict(batch=batch, solved=solved, err_p99=err_p99, cert=cert,
                          ms=t * 1e3, solves_per_s=batch / t)
    return dict(launches=launches, configs=summary)


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
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.last_build_seconds:.2f} s) "
        f"into {_build.build_dir()}")

    # 3. each kernel against its plain version at the main path's shapes
    log("kernels against their plain versions (float32, atol = rtol = 1e-4):")
    k1 = [compare_step(4096, 32, dev, reps=20), compare_step(1024, 128, dev, reps=8)]
    k2 = [compare_polish(4096, 32, 6, dev, reps=20), compare_polish(1024, 128, 4, dev, reps=8)]
    for name, rows in (("sqp_step", k1), ("polish_kkt", k2)):
        for r in rows:
            log(f"  {name} n={r['n']} B={r['batch']}: kernel {r['ms']:.3f} ms, "
                f"plain {r['plain_ms']:.3f} ms [{card}]")

    # 4. the main path end to end
    log("main path: sqp_solve_batch(impl='fused') on the sphere-cap family:")
    main_run = run_main_path([(32, 4096), (128, 1024)], dev, card)

    def entry(name, replaces, rows):
        head = rows[0]
        return dict(
            name=name, route="cuda", source=CU_SOURCE, replaces=replaces,
            launches=main_run["launches"][name], max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            shape=dict(n=head["n"], batch=head["batch"]), by_shape=rows,
        )

    kernels = [entry("sqp_step", K1_SOURCE, k1), entry("polish_kkt", K2_SOURCE, k2)]
    log(json.dumps(dict(main_path=main_run["configs"], card=card)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
