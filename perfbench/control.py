"""The control of the check that decides ``correct``: the reference solver
(:mod:`perfbench.reference.admm`) put in the program's place, on a cell's
own batches, judged by the same check (:mod:`perfbench.reference.check`).

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 [--batches 2]
        [--precision tf32,float32,float64]

From the root of a checkout, on the card (or ``--device cpu``).  For each
seed it draws the cell's pool as a run does, solves its first ``--batches``
batches at the cell's batch size with the reference in ``--precision``
(``tf32``: the nearest precision below the configuration's float32 with
TF32 off) and prints the compared numbers beside the configuration's
limits: the control has to fail one of them.  The benchmark's runs never
run it.  The last line is one JSON object of every seed's readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(bench: dict, workload: str, seed: int, batches: int, precision: str,
                     device, overrides=None) -> dict:
    """The check's numbers over the reference's answers on the first
    ``batches`` batches of the cell's pool for ``seed``."""
    from perfbench.generator import make_pool
    from perfbench.harness import cell_of, check_lines, limits_of
    from perfbench.reference.admm import admm_solve
    from perfbench.reference.check import answer_readings, summarize

    _, cfg, mix = cell_of(bench, workload)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    s = cfg["settings"]
    readings = []
    for qp in make_pool(cfg, mix, seed, device)[:batches]:
        ans = admm_solve(qp["P"], qp["q"], qp["A"], qp["l"], qp["u"], s, precision)
        readings.append(answer_readings(qp, ans, s["eps_abs"], s["eps_rel"]))
    summary = summarize(readings)
    correct, lines = check_lines(summary, limits_of(workload))
    return dict(summary, correct=correct, checks=lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--precision", default="tf32",
                    help="one or more of tf32, float32, float64, comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import load_bench

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = load_bench()
    out = {}
    for precision in args.precision.split(","):
        if precision not in ("tf32", "float32", "float64"):
            raise SystemExit(f"control: no precision {precision!r}")
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = control_readings(bench, args.workload, seed, args.batches, precision,
                                 torch.device(args.device))
            r["seconds"] = time.perf_counter() - t0
            out[f"{precision}.{seed}"] = r
            print(f"control {args.workload} {precision} seed {seed}: correct {r['correct']}, "
                  f"solved {r['solved']} of {r['judged']}, " + ", ".join(
                      f"{k} {c['value']!r} (limit {c['limit']!r})" for k, c in r["checks"].items())
                  + f" [{r['seconds']:.1f} s]", flush=True)
    print(json.dumps(dict(workload=args.workload, readings=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
