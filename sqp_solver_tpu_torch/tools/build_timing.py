"""Cold build times of the kernel library and of the structured kernel's instantiations.

Times two ways to build ``csrc/*.cu`` from nothing: one nvcc process per
source, all started together, plus a link (what ``ops/_build.py`` does),
and one nvcc process over every source.  Each build goes to a fresh
directory under ``build/`` and is deleted after; the order is split,
single, single, split.  With ``--instances`` it times instead one
``nvcc -c`` of ``csrc/qp_kernel_btd.cu`` with no instantiation of the
kernel, then with each of ``BTD_INSTANCES`` alone, then with all of them,
one after another.  Prints one JSON line with the seconds of each run.
Needs nvcc, not a card::

    python -m sqp_solver_tpu_torch.tools.build_timing [--instances]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import tempfile
import time
from pathlib import Path

from sqp_solver_tpu_torch.ops import _build


def _single(cu, so: Path) -> None:
    _build._run_all([[_build.nvcc_path(), *_build._NVCC_FLAGS, "-shared", "-o", str(so),
                      *map(str, cu)]])


def _timed(root: Path, build) -> float:
    tmp = Path(tempfile.mkdtemp(dir=root))
    try:
        t0 = time.perf_counter()
        build(tmp)
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)


def split_single(root: Path) -> dict:
    cu, _ = _build._sources()
    seconds = {"split": [], "single": []}
    for way in ("split", "single", "single", "split"):
        build = _build._compile if way == "split" else _single
        seconds[way].append(_timed(root, lambda tmp: build(cu, tmp / "lib.so")))
    return {"sources": [p.name for p in cu], "seconds": seconds}


def instances(root: Path) -> dict:
    src = _build._CSRC / "qp_kernel_btd.cu"
    line = re.search(r"#define BTD_INSTANCES (.*)", src.read_text()).group(1)
    runs = [("none", "")] + [(x, x) for x in re.findall(r"X\(\d+, \d+\)", line)]

    def build(inst, tmp: Path) -> None:
        # a unit that sets the list and includes the source, so that no
        # nvcc command line carries it
        unit = tmp / "unit.cu"
        head = "" if inst is None else f"#define BTD_INSTANCES {inst}\n"
        unit.write_text(f'{head}#include "{src}"\n')
        _build._run_all([[_build.nvcc_path(), *_build._NVCC_FLAGS, "-c", "-o",
                          str(tmp / "unit.o"), str(unit)]])

    seconds = {label: _timed(root, lambda tmp, inst=inst: build(inst, tmp))
               for label, inst in runs + [("all", None)]}
    return {"source": src.name, "seconds": seconds}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instances", action="store_true")
    args = ap.parse_args()
    root = _build.build_dir().parent
    root.mkdir(parents=True, exist_ok=True)
    print(json.dumps(instances(root) if args.instances else split_single(root)))


if __name__ == "__main__":
    main()
