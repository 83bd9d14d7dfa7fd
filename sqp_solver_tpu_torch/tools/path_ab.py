"""A path and its kernel, this checkout against another tree, on the card.

    python -m sqp_solver_tpu_torch.tools.path_ab --parent build/parent \
        [--path btd_nlp|fused_wide] [--turns 2]

``--parent`` is the root of another checkout (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Unlike
``kernel_ab``, which drives both trees' libraries from this checkout's
Python, each tree here runs in a process of its own through its own
package and its own ``chip_smoke.py`` helpers, so the wrapper around the
kernel (what the host does at each launch) is measured too, and the two
trees' C interfaces may differ.  Both trees' libraries are built first,
the two builds at once; then the trees run in turns parent, change,
change, parent (``--turns`` a tree), each turn a fresh process.  With
``--path btd_nlp`` (the default) a turn measures:

``k7_ms``       the wide K7 (``chip_smoke.btd_wide_step_case``: random band
                QPs at n = 128, m = 224, internal block 64, B = 64, the
                shape of the structured NLP's wide launches), CUDA events,
                the mean of ``--reps`` launches after a warm-up;
``k7_host_ms``  the host's time inside one ``btd_step_kernel`` call
                (``perf_counter`` around the call, the card idle before
                it), the mean of ``--reps`` calls: a wrapper that reads a
                result back waits for the kernel here;
``nlp_ms``      ``sqp_solve_batch(impl="fused", qp_impl="kernel_btd")`` on
                the unicycle family at horizon 32, B = 64 and block 64
                (``chip_smoke.btd_nlp_settings(block=64)``), host wall
                with a sync at each end, after a warm-up, one problem set
                a seed (seeds 0 .. ``--walls`` - 1; min and median), with
                the wide K7 launches of seed 0 counted.

With ``--path fused_wide`` (leg O of ``chip_smoke.py``):

``k5_ms``       the wide K5 at n = m = 640 (D = 1280), B = 256, seg 10
                (``chip_smoke.chunk_operands``), CUDA events, the mean of
                ``--reps`` launches after a warm-up;
``k5_host_ms``  the host's time inside one ``admm_chunk_kernel`` call, as
                ``k7_host_ms``;
``leg_ms``      ``qp_solve_batch(impl="fused")`` on random QPs n = m = 640,
                B = 256, drawn on the card, at the QP legs' settings
                (``chip_smoke.qp_bench_settings``), host wall as ``nlp_ms``,
                one problem set a seed, with the K5 launches of seed 0
                counted.

The last line of the output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


# each path's numbers, in the order they are printed
KEYS = {"btd_nlp": ("k7_ms", "k7_host_ms", "nlp_ms", "nlp_median_ms"),
        "fused_wide": ("k5_ms", "k5_host_ms", "leg_ms", "leg_median_ms")}


def _host_ms(call, reps: int) -> float:
    """Mean host milliseconds inside ``call()``, the card idle before each."""
    import torch

    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * sum(host) / len(host)


def _walls(solve, seeds) -> list:
    """Host wall of ``solve(seed)`` for each seed, synchronised at both ends."""
    import torch

    out = []
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(seed)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _worker(tree: Path, path: str, build_only: bool, reps: int, walls: int) -> dict:
    """One turn in ``tree``: its package and its ``chip_smoke``."""
    sys.path[0] = str(tree)  # in place of this script's directory
    from sqp_solver_tpu_torch.ops import _build

    _build.load()
    if build_only:
        return dict(built=True)
    return (_fused_wide if path == "fused_wide" else _btd_nlp)(reps, walls)


def _fused_wide(reps: int, walls: int) -> dict:
    """Leg O and its wide K5 launch in this process's tree."""
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.models.families import random_qp_batch_device
    from sqp_solver_tpu_torch.ops import admm_kernel as ak
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    dev = torch.device("cuda")
    args = cs.chunk_operands(256, 640, 640, 10, dev)
    call = lambda: ak.admm_chunk_kernel(*args, alpha=1.6, seg=10)  # noqa: E731
    k5_ms = cs.cuda_ms(call, reps)
    k5_host_ms = _host_ms(call, reps)
    settings = cs.qp_bench_settings()
    problems = {seed: random_qp_batch_device(torch.Generator(device=dev).manual_seed(seed), 256,
                                             640, 640) for seed in (100, *range(walls))}
    solve = lambda seed: qp_solve_batch(problems[seed], settings, impl="fused")  # noqa: E731
    solve(100)  # warm-up
    before = ak.admm_chunk_launches
    leg = _walls(solve, [0])
    launches = ak.admm_chunk_launches - before
    leg += _walls(solve, range(1, walls))
    return dict(k5_ms=k5_ms, k5_host_ms=k5_host_ms, leg_ms=min(leg),
                leg_median_ms=statistics.median(leg), leg_walls_ms=leg, leg_k5_launches=launches,
                card=cs.card_line())


def _btd_nlp(reps: int, walls: int) -> dict:
    """The structured NLP's block-64 leg and its wide K7 launch in this
    process's tree."""
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.models.mpc import mpc_nlp_stagewise_batch
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.parallel.batch import sqp_solve_batch

    dev = torch.device("cuda")
    c = cs.btd_wide_step_case(64, 2, 64, 224, dev)
    t, s = c["t"], c["settings"]
    k7_ms = cs.cuda_ms(lambda: cs.btd_launch(t, s, False), reps)

    def call():
        return qb.btd_step_kernel(*(t[k] for k in ("pd", "pe", "J", "g", "l", "u", "active",
                                                   "x", "z", "y")), s, rho_in=t.get("rho_in"))

    k7_host_ms = _host_ms(call, reps)
    settings = cs.btd_nlp_settings(block=64)
    problems = {seed: mpc_nlp_stagewise_batch(64, horizon=32, seed=seed, device=dev)
                for seed in (100, *range(walls))}

    def solve(seed):
        problem, x0, _ = problems[seed]
        sqp_solve_batch(problem, x0, None, settings, impl="fused")

    solve(100)  # warm-up
    before = qb.btd_step_wide_launches
    nlp = _walls(solve, [0])
    launches = qb.btd_step_wide_launches - before
    nlp += _walls(solve, range(1, walls))
    return dict(k7_ms=k7_ms, k7_host_ms=k7_host_ms, k7_iter=float(call().iter.float().mean()),
                nlp_ms=min(nlp), nlp_median_ms=statistics.median(nlp), nlp_walls_ms=nlp,
                nlp_wide_launches=launches, card=cs.card_line())


def _turn(tree: Path, *extra: str) -> dict:
    """One worker process in ``tree``; its result (the last line of its
    output)."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree), *extra]
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: worker failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--path", choices=sorted(KEYS), default="btd_nlp")
    ap.add_argument("--turns", type=int, default=2, help="turns a tree (even)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--walls", type=int, default=5)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(_worker(args.worker.resolve(), args.path, args.build_only, args.reps,
                                 args.walls)), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    trees = dict(parent=args.parent.resolve(), change=ROOT)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(lambda tree: _turn(tree, "--build-only"), trees.values()))
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    order = (["parent", "change"] + ["change", "parent"]) * max(1, args.turns // 2)
    rows = {who: [] for who in trees}
    keys = KEYS[args.path]
    for who in order:
        r = _turn(trees[who], "--path", args.path, "--reps", str(args.reps), "--walls",
                  str(args.walls))
        rows[who].append(r)
        if args.path == "btd_nlp":
            print(f"{who}: K7 wide {r['k7_ms']:.3f} ms ({r['k7_iter']:.1f} ADMM iterations), "
                  f"host in the call {r['k7_host_ms']:.3f} ms; NLP block 64 min "
                  f"{r['nlp_ms']:.3f} ms, median {r['nlp_median_ms']:.3f} ms, "
                  f"{r['nlp_wide_launches']} wide K7 [{r['card']}]", flush=True)
        else:
            print(f"{who}: K5 wide D=1280 B=256 seg 10 {r['k5_ms']:.3f} ms, host in the call "
                  f"{r['k5_host_ms']:.3f} ms; leg O min {r['leg_ms']:.3f} ms, median "
                  f"{r['leg_median_ms']:.3f} ms, {r['leg_k5_launches']} K5 [{r['card']}]",
                  flush=True)
    mean = {who: {k: statistics.fmean(r[k] for r in rs) for k in keys}
            for who, rs in rows.items()}
    for k in keys:
        print(f"{k}: parent {mean['parent'][k]:.3f}, change {mean['change'][k]:.3f}, "
              f"parent / change {mean['parent'][k] / mean['change'][k]:.3f}x", flush=True)
    print(json.dumps(dict(path=args.path, order=order, turns=rows, mean=mean)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
