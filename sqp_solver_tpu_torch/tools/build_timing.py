"""Cold build time of the kernel library, split against single.

Times two ways to build ``csrc/*.cu`` from nothing: one nvcc process per
source, all started together, plus a link (what ``ops/_build.py`` does),
and one nvcc process over every source.  Each build goes to a fresh
directory under ``build/`` and is deleted after; the order is split,
single, single, split.  Prints one JSON line with the seconds of each run.
Needs nvcc, not a card::

    python -m sqp_solver_tpu_torch.tools.build_timing
"""

from __future__ import annotations

import json
import shutil
import tempfile
import time
from pathlib import Path

from sqp_solver_tpu_torch.ops import _build


def _single(cu, so: Path) -> None:
    _build._run_all([[_build.nvcc_path(), *_build._NVCC_FLAGS, "-shared", "-o", str(so),
                      *map(str, cu)]])


def main() -> None:
    cu, _ = _build._sources()
    root = _build.build_dir().parent
    root.mkdir(parents=True, exist_ok=True)
    seconds = {"split": [], "single": []}
    for way in ("split", "single", "single", "split"):
        tmp = Path(tempfile.mkdtemp(dir=root))
        try:
            t0 = time.perf_counter()
            (_build._compile if way == "split" else _single)(cu, tmp / "lib.so")
            seconds[way].append(time.perf_counter() - t0)
        finally:
            shutil.rmtree(tmp)
    print(json.dumps({"sources": [p.name for p in cu], "seconds": seconds}))


if __name__ == "__main__":
    main()
