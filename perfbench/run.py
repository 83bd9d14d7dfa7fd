"""Run one cell of the port's benchmark (``BENCHMARK.json``) on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Draws the cell's pool of problems on the card
from ``--seed``, warms up, then calls the program's entry in a closed loop
for ``--seconds`` (``--trace 1``: under ``torch.profiler``, for at most the
traffic mix's ``trace_seconds``), judges every answer that the window
returned (:mod:`perfbench.reference.check`), prints the compared numbers
with their limits as the last lines of standard error and one JSON object
as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
``checks`` last.  Exits non-zero, printing no result, without enough CUDA
cards or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """The epoch time at which this process started (its start tick in
    ``/proc``), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import cell_of, forbidden_modules, load_bench, run_cell

    bench = load_bench()
    cell, _, _ = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line, notes = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"perfbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed {args.seed}: {notes['calls']} calls in "
          f"{notes['window_s']:.3f} s, set-up {notes['setup_s']:.3f} s, {notes['judged']} "
          f"answers judged, {notes['solved']} solved, trace read in {notes['trace_s']:.1f} s; "
          "set-up by step (s): " + ", ".join(f"{k} {v:.3f}" for k, v in notes["phases"].items()),
          file=sys.stderr)
    if notes["missing"]:
        print(f"perfbench: {args.workload} lists {', '.join(notes['missing'])}, which found "
              "nothing to read in this run and are left out of the line", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
