"""One run of one cell: set-up, the measured window, the trace, the check.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` (read by :mod:`perfbench.generator`), the
limits of its check in ``workloads/<cell>.json``, each metric's reader in
``metrics/<metric>.py``.  A reader is a module with
``read(rec) -> float | None``; ``rec`` is the :class:`Record` of the run,
and a reader that finds nothing to read returns None, which leaves the
metric out of the line.

The window is a closed loop with one client: the entry is called,
cold-started, on the next batch of the pool only after the last call
returned and ``torch.cuda.synchronize()`` closed it.  Every answer that the window
returned is kept and, once the window has closed and the peak memory has
been read, judged by :mod:`perfbench.reference.check`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from perfbench.generator import make_pool
from perfbench.reference.check import answer_readings, summarize

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CSRC = ROOT / "sqp_solver_tpu_torch" / "csrc"
FORBIDDEN = ("jax", "jaxlib", "flax", "sqp_solver_tpu")

__all__ = ["Record", "load_bench", "cell_of", "limits_of", "metrics_of", "run_cell",
           "forbidden_modules", "read_json", "check_lines"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> tuple:
    """(cell, configuration, traffic mix) of the workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r}; workloads: {sorted(cells)}")
    cell = cells[name]
    return (cell, read_json(HERE / "configs" / f"{cell['config']}.json"),
            read_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def limits_of(name: str) -> dict:
    """The limit of each number that the check of cell ``name`` compares."""
    return read_json(HERE / "workloads" / f"{name}.json")["limits"]


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics that this cell reports: its end-to-end ones without a
    trace, its per-layer ones with one (a metric without ``workloads``
    belongs to every cell)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the JAX
    package's, compared whole: the port's name begins with the JAX
    package's."""
    import sys

    names = list(sys.modules) if names is None else names
    return sorted({k.split(".")[0] for k in names} & set(FORBIDDEN))


def handwritten_kernels(csrc: Path = CSRC) -> tuple:
    """The names of the program's hand-written kernels (``__global__``
    functions of its CUDA sources)."""
    import re

    names = set()
    for p in sorted(csrc.glob("*.cu")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                p.read_text()))
    return tuple(sorted(names))


@dataclasses.dataclass
class Trace:
    """The device's operations and the host's spans of a traced window, in
    microseconds from the profiler's start."""

    window: tuple  # (start, end) of the traced window
    ops: list  # (name, start, end, kernel?) of each device operation
    host: list  # (start, end, name) of the host's operations, for the idle gaps


@dataclasses.dataclass
class Record:
    """What a run measured, as the metric readers see it."""

    cfg: dict
    mix: dict
    settings: object
    pool: list
    window_s: float
    walls: list  # seconds of each call
    order: list  # the pool batch of each call
    results: list  # each call's answer
    solved: int
    attempted: int
    setup_s: float
    handwritten: tuple
    trace: Optional[Trace] = None


def settings_of(cfg: dict, mix: dict):
    from sqp_solver_tpu_torch.qp.types import QPSettings

    block = cfg["stage_block"] if mix["block"] == "stage" else 0
    return QPSettings(**cfg["settings"], linear_solver=mix["linear_solver"], block_size=block)


def _build_seconds() -> float:
    """The seconds that this process spent building the program's kernel
    library (0 where the checkout's build was already there): part of
    ``setup_s`` on a checkout's first run, reported apart."""
    from sqp_solver_tpu_torch.ops import _build

    return float(_build.last_build_seconds)


def _window(entry: Callable, qps: list, settings, impl: str, seconds: float, spans: bool,
            sync: Callable):
    """Closed loop for ``seconds``: (elapsed, walls, order, results)."""
    walls, order, results = [], [], []
    rf = torch.profiler.record_function
    t_open = time.perf_counter()
    i = 0
    while True:
        k = i % len(qps)
        t0 = time.perf_counter()
        if spans:
            with rf("perfbench.call"):
                res = entry(qps[k], settings, impl=impl)
            with rf("perfbench.sync"):
                sync()
        else:
            res = entry(qps[k], settings, impl=impl)
            sync()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        order.append(k)
        results.append(res)
        i += 1
        if t1 - t_open >= seconds:
            return t1 - t_open, walls, order, results


def _raw_events(prof):
    """(name, on the device?, start us, end us, thread, user annotation?)
    of every profiled event, from
    the profiler's raw results (building its event tree costs minutes on a
    window of a few hundred thousand launches)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        annot = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
        yield (e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() * 1e-3,
               (e.start_ns() + e.duration_ns()) * 1e-3, e.start_thread_id(), annot)


def _reduce_trace(prof) -> Trace:
    events = list(_raw_events(prof))
    thread = next((ev[4] for ev in events if ev[0] == "perfbench.window" and not ev[1]), None)
    window, host, ops = None, [], []
    for name, on_dev, t0, t1, th, annot in events:
        if on_dev:
            # the harness's spans show on the device's timeline too, over the
            # work launched inside them: no work themselves
            if not (annot or name.startswith("perfbench.")):
                kernel = not name.lower().startswith(("memcpy", "memset"))
                ops.append((name, t0, t1, kernel))
            continue
        if name == "perfbench.window":
            window = (t0, t1)
        if th == thread:
            host.append((t0, t1, name))
    if window is None:
        raise RuntimeError("perfbench: the traced window's span is missing from the trace")
    return Trace(window=window, ops=ops, host=host)


def busy_intervals(trace: Trace) -> list:
    """The union of the device operations' intervals inside the window."""
    w0, w1 = trace.window
    iv = sorted((max(s, w0), min(e, w1)) for _, s, e, _ in trace.ops if e > w0 and s < w1)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    time by what the host was doing (the innermost host operation open at
    each gap's middle), each in seconds."""
    by_op = {}
    for name, s, e, _ in trace.ops:
        key = name[:120]
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-6
    busy = busy_intervals(trace)
    w0, w1 = trace.window
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    # one sweep over the host's operations, which nest: the innermost one
    # open at a time is the top of the stack of those open then
    host = sorted(trace.host, key=lambda h: (h[0], -h[1]))
    by_gap, stack, j = {}, [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        key = stack[-1][2] if stack else "(no host operation)"
        by_gap[key] = by_gap.get(key, 0.0) + (e - s) * 1e-6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return dict(device_ops=[[k, v] for k, v in order(by_op)],
                idle_gaps=[[k, v] for k, v in order(by_gap)])


def check(rec: Record, eps_abs: float, eps_rel: float) -> dict:
    """Every answer of the window judged against the inputs of its batch."""
    return summarize([answer_readings(rec.pool[k], dict(
        x=res.x, z=res.z, y=res.y, status=res.info.status, res_prim=res.info.res_prim,
        res_dual=res.info.res_dual), eps_abs, eps_rel) for res, k in zip(rec.results, rec.order)])


def check_lines(summary: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the compared numbers.  A
    number with no reading (None: no answer of its kind, where every sound
    run has some) or a non-finite one fails, and shows as null."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = summary[name]
        finite = value is not None and math.isfinite(value)
        out[name] = dict(value=value if finite else None, limit=limit)
        ok = ok and finite and value <= limit
    return ok, out


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, entry: Optional[Callable] = None, overrides: Optional[dict] = None):
    """One run of cell ``name``: returns (result line, check lines).
    ``entry`` replaces the program's ``qp_solve_batch`` and ``overrides``
    the configuration's and the traffic's keys (the tests' small runs)."""
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp.types import QuadraticProblem

    t_imported = time.time()
    cell, cfg, mix = cell_of(bench, name)
    limits = limits_of(name)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    entry = entry or qp_solve_batch
    settings = settings_of(cfg, mix)
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    pool = make_pool(cfg, mix, seed, device)
    qps = [QuadraticProblem(P=b["P"], q=b["q"], A=b["A"], l=b["l"], u=b["u"]) for b in pool]
    sync()
    t_pool = time.time()
    for _ in range(mix["warmup_calls"]):
        entry(qps[0], settings, impl=mix["impl"])
    sync()
    t_open = time.time()
    setup_s = t_open - t_start
    # the pool's step holds CUDA's start (its first call on the card); the
    # warm-up's holds a checkout's build of the kernel library
    phases = dict(imports=t_imported - t_start, pool=t_pool - t_imported,
                  warmup=t_open - t_pool, build=_build_seconds())
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        span = min(seconds, mix["trace_seconds"])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("perfbench.window"):
                elapsed, walls, order, results = _window(entry, qps, settings, mix["impl"],
                                                         span, True, sync)
    else:
        elapsed, walls, order, results = _window(entry, qps, settings, mix["impl"], seconds,
                                                 False, sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    statuses = torch.cat([r.info.status for r in results])
    solved = int((statuses == 0).sum())
    t_trace = time.perf_counter()
    rec = Record(cfg=cfg, mix=mix, settings=settings, pool=pool, window_s=elapsed, walls=walls,
                 order=order, results=results, solved=solved, attempted=int(statuses.numel()),
                 setup_s=setup_s, handwritten=handwritten_kernels(),
                 trace=_reduce_trace(prof) if prof is not None else None)
    t_trace = time.perf_counter() - t_trace
    del prof
    summary = check(rec, cfg["settings"]["eps_abs"], cfg["settings"]["eps_rel"])
    correct, lines = check_lines(summary, limits)
    metrics, missing = {}, []
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"])(rec)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell["chips"], memory_peak_bytes=int(peak))
    line = dict(correct=correct, attempted=rec.attempted, failed=rec.attempted - solved,
                metrics=metrics, device=dev)
    if rec.trace is not None:
        busy = sum(e - s for s, e in busy_intervals(rec.trace)) * 1e-6
        dev.update(busy_s=busy, window_s=(rec.trace.window[1] - rec.trace.window[0]) * 1e-6)
        line["breakdown"] = breakdown(rec.trace)
    line["checks"] = lines
    return line, dict(summary, calls=len(walls), window_s=elapsed, setup_s=setup_s,
                      trace_s=t_trace, phases=phases, missing=missing)
