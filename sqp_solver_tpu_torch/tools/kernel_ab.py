"""This checkout's kernels against another tree's, on the card.

    python -m sqp_solver_tpu_torch.tools.kernel_ab --parent build/parent

``--parent`` is the root of another checkout (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Both trees'
``csrc/*.cu`` are built into libraries under ``build/kernel_ab/``; the
Python around the kernels is this checkout's, which is valid as long as
the C interface of the kernels compared is the same in both trees.  Three
parts, in order (``--parts`` picks some):

``bits``    K1 (``sqp_step_kernel``) and K3 (``qp_solve_kernel``) of both
            trees on the same seeded inputs (``chip_smoke.py``'s shapes):
            every output tensor must be equal bit for bit;
``time``    K6/K7 milliseconds at every ``chip_smoke.py`` shape
            (``chip_smoke.btd_cases``), CUDA events, in turns parent,
            change, change, parent;
``phases``  the phase split of the structured kernel: each tree's
            ``qp_kernel_btd.cu`` built with ``-DADMM_PHASE_CLOCKS`` against
            this checkout's ``admm_core.cuh`` (whose ``ADMM_PHASE_*`` marks
            bound the ADMM core's phases; a kernel source without its own
            Gram / Thomas and total marks gets them inserted at the anchors
            of ``_MARKS``), one launch per shape; thread 0 of each block
            sums the clock64() spans of Gram band, block Thomas, A'w (with
            tm = rho z - y), the sweeps, A v (with the z, y, x updates), the
            chunk statistics and the whole kernel.

The last line of the output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("gram", "thomas", "atmv", "sweep", "amv", "stats", "total")
# (anchor, replacement) for a structured kernel source from before the
# phase marks (the first structured kernel, one block per problem); a tree
# that has the marks needs none of this
_MARKS = (
    ("  extern __shared__ float smem[];\n",
     "  extern __shared__ float smem[];\n  ADMM_PHASE_BEGIN(kPhTotal);\n"),
    ("    __syncthreads();\n    bool fail = false;\n",
     "    __syncthreads();\n    ADMM_PHASE_END(kPhGram);\n    ADMM_PHASE_BEGIN(kPhThomas);\n"
     "    bool fail = false;\n"),
    ("  if (tid == 0) {  // stats is (9, batch)",
     "  ADMM_PHASE_END(kPhTotal);\n  if (tid == 0) {  // stats is (9, batch)"),
)


def _lib(tree: Path, label: str):
    from sqp_solver_tpu_torch.ops import _build

    return _build.build_library(tree / "sqp_solver_tpu_torch" / "csrc",
                                _build.build_dir().parent / "kernel_ab" / label)


def _phase_lib(tree: Path, label: str):
    """The structured kernel of ``tree`` with phase clocks."""
    from sqp_solver_tpu_torch.ops import _build

    out = _build.build_dir().parent / "kernel_ab" / f"{label}-phases"
    csrc = out / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    src = (tree / "sqp_solver_tpu_torch" / "csrc" / "qp_kernel_btd.cu").read_text()
    if "kPhGram" not in src:
        for anchor, repl in _MARKS:
            if src.count(anchor) != 1:
                raise RuntimeError(f"{label}: phase anchor not found once: {anchor!r}")
            src = src.replace(anchor, repl)
    (csrc / "qp_kernel_btd.cu").write_text(src)
    for header in (ROOT / "sqp_solver_tpu_torch" / "csrc").glob("*.cuh"):
        shutil.copy(header, csrc / header.name)
    lib = _build.build_library(csrc, out, flags=("-DADMM_PHASE_CLOCKS",))
    lib.admm_phase_clocks.restype = ctypes.c_int
    lib.admm_phase_clocks.argtypes = [ctypes.c_void_p]
    return lib


def _use(lib) -> None:
    from sqp_solver_tpu_torch.ops import _build

    _build._lib = lib


def _tensors(out) -> dict:
    import torch

    return {k: v for k, v in out._asdict().items() if isinstance(v, torch.Tensor)}


def bits(libs: dict, dev) -> list:
    """K1 and K3 of both trees on the same inputs; raises unless equal."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.testing import step_inputs

    s = cs.main_qp_settings()
    cases = []
    for batch, n in ((4096, 32), (1024, 128)):
        t = cs.to_device(step_inputs(batch, n, n + 1, seed=n, dtype=np.float32,
                                     equality_row=False), dev)
        for bfgs in (True, False):
            cases.append((f"K1 n={n} do_bfgs={bfgs}", lambda t=t, bfgs=bfgs: qk.sqp_step_kernel(
                t["B"], t["J"], t["g"], t["l"], t["u"], t["s"], t["dgl"], t["reset"], t["upd"],
                t["active"], t["x"], t["z"], t["y"], s, do_bfgs=bfgs, want_minv=True)))
    for family, n in (("random", 32), ("mpc", 16)):
        t = cs.qp_operands(family, 4096, n, dev)
        for label, qs in (("one epoch", cs.qp_bench_settings(adaptive_rho=False)),
                          ("4 epochs", cs.qp_bench_settings())):
            cases.append((f"K3 {family} n={n} {label}",
                          lambda t=t, qs=qs: cs.qp_raw(qk._qp_solve_launch, t, qs)))
    rows = []
    for label, fn in cases:
        outs = {}
        for who, lib in libs.items():
            _use(lib)
            outs[who] = _tensors(fn())
        torch.cuda.synchronize()
        differ = [k for k, v in outs["parent"].items() if not torch.equal(v, outs["change"][k])]
        cs.log(f"  {label}: {len(outs['parent'])} outputs, "
               f"{'bit for bit equal' if not differ else 'DIFFER: ' + ', '.join(differ)}")
        if differ:
            raise AssertionError(f"{label}: outputs differ from the parent's: {differ}")
        rows.append(dict(case=label, outputs=len(outs["parent"]), equal=True))
    return rows


def timing(libs: dict, cases: list) -> list:
    """K6/K7 ms of both trees at each shape, in turns parent, change,
    change, parent; between the change's turns, two turns of the change
    with the other number of blocks per problem, where it has one."""
    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    rows = []
    for c in cases:
        reps = 3 if "random" in c["label"] else 5
        _use(libs["change"])
        rule = qb.cluster_size(c["n"], c["m"], c["bb"], c["batch"])
        other = 3 - rule if c["bb"] <= 16 else None
        turns = ["parent", "change"] + ["other"] * 2 * (other is not None) + ["change", "parent"]
        ms = {who: [] for who in turns}
        for who in turns:
            _use(libs["parent" if who == "parent" else "change"])
            cl = other if who == "other" else None
            ms[who].append(cs.cuda_ms(lambda: cs.btd_launch(
                c["t"], c["settings"], c["check_infeas"], cluster=cl), reps))
        mean = {who: sum(v) / len(v) for who, v in ms.items()}
        alt = (f", the change with {other} block(s) per problem {mean['other']:.3f} ms"
               if other is not None else "")
        cs.log(f"  {c['label']} (n={c['n']}, m={c['m']}): parent {mean['parent']:.3f} ms, change "
               f"({rule} block(s) per problem) {mean['change']:.3f} ms, parent / change "
               f"{mean['parent'] / mean['change']:.2f}x{alt} (means of 2 turns of {reps} "
               f"launches: {ms})")
        rows.append(dict(case=c["label"], n=c["n"], m=c["m"], batch=c["batch"],
                         cluster=rule, parent_ms=mean["parent"], change_ms=mean["change"],
                         speedup=mean["parent"] / mean["change"],
                         other_cluster=other, other_ms=mean.get("other"), turns=ms))
    return rows


def phases(phase_libs: dict, cases: list) -> list:
    """Per-block clock64() cycles of each phase, one launch per shape."""
    import numpy as np
    import torch

    import chip_smoke as cs

    rows = []
    buf = np.zeros(len(PHASES), dtype=np.uint64)
    for c in cases:
        for who, lib in phase_libs.items():
            _use(lib)
            cs.btd_launch(c["t"], c["settings"], c["check_infeas"])  # warm-up
            lib.admm_phase_clocks(buf.ctypes.data)
            out = cs.btd_launch(c["t"], c["settings"], c["check_infeas"])
            torch.cuda.synchronize()
            rc = lib.admm_phase_clocks(buf.ctypes.data)
            if rc:
                raise RuntimeError(f"admm_phase_clocks failed ({rc})")
            per = int(lib.qp_btd_cluster_size(c["n"], c["m"], c["bb"], c["batch"])) \
                if hasattr(lib, "qp_btd_cluster_size") else 1
            blocks = per * c["batch"]
            cyc = {p: float(buf[i]) / blocks for i, p in enumerate(PHASES)}
            iters = float(out.iter.double().mean())
            share = {p: cyc[p] / cyc["total"] for p in PHASES[:-1]}
            per_iter = {p: cyc[p] / max(iters, 1.0) for p in ("atmv", "sweep", "amv")}
            cs.log(f"  {c['label']} {who} ({per} block(s) per problem, mean {iters:.1f} "
                   "iterations): cycles per block " +
                   ", ".join(f"{p} {cyc[p]:.0f} ({share.get(p, 1.0):.3f})" for p in PHASES) +
                   "; per iteration " + ", ".join(f"{p} {v:.0f}" for p, v in per_iter.items()))
            rows.append(dict(case=c["label"], tree=who, blocks_per_problem=per,
                             mean_iter=iters, cycles_per_block=cyc, share=share,
                             cycles_per_iteration=per_iter))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--parts", default="bits,time,phases")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(f"card: {card}")
    parts = args.parts.split(",")
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    result = dict(card=card)
    if "bits" in parts or "time" in parts:
        libs = {who: _lib(tree, who) for who, tree in trees.items()}
    cases = cs.btd_cases(dev) if ("time" in parts or "phases" in parts) else []
    if "bits" in parts:
        cs.log("K1 and K3, parent against change:")
        result["bits"] = bits(libs, dev)
    if "time" in parts:
        cs.log("K6/K7 ms at the chip_smoke.py shapes:")
        result["time"] = timing(libs, cases)
    if "phases" in parts:
        cs.log("structured kernel phase split (clock64, thread 0 of each block):")
        phase_libs = {who: _phase_lib(tree, who) for who, tree in trees.items()}
        result["phases"] = phases(phase_libs, cases)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
