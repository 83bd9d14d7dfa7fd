"""Build ``csrc/*.cu`` with nvcc into a shared library and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so a build takes
seconds.  It is built at first use into ``build/torch_kernels/`` beside
the package (a directory that ``.gitignore`` lists), under a name that
carries a hash of the sources, so an edited source is never served by a
stale build.  Each source compiles in its own nvcc process, all started
together, and one more links the objects.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["load", "build_library", "build_dir", "nvcc_path", "last_build_seconds",
           "last_unit_seconds"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None
last_build_seconds = 0.0  # wall time of the last nvcc run (0 when cached)
last_unit_seconds: dict = {}  # each source's nvcc seconds in that run

_VOID, _INT, _FLOAT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

_SIGNATURES = {
    "sqp_step_launch": (
        _INT,
        [_VOID] * 22 + [_INT] * 3 + [_FLOAT] * 5 + [_INT] * 4 + [_FLOAT, _INT, _INT, _VOID],
    ),
    "sqp_step_launch_aa": (
        _INT,
        [_VOID] * 22 + [_INT] * 3 + [_FLOAT] * 5 + [_INT] * 4 + [_FLOAT, _INT, _INT, _VOID]
        + [_INT, _VOID],
    ),
    "sqp_step_workspace_floats": (_LL, [_INT, _INT]),
    "admm_aa_floats": (_LL, [_INT] * 3),
    "polish_kkt_launch": (
        _INT,
        [_VOID] * 12 + [_INT] * 3 + [_FLOAT, _INT, _INT, _VOID],
    ),
    "polish_kkt_launch_reuse": (
        _INT,
        [_VOID] * 15 + [_INT] * 3 + [_FLOAT, _INT, _INT, _VOID],
    ),
    "polish_kkt_workspace_floats": (_LL, [_INT, _INT]),
    "qp_solve_launch": (
        _INT,
        [_VOID] * 13 + [_INT] * 3 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID],
    ),
    "qp_solve_launch_as": (
        _INT,
        [_INT] + [_VOID] * 13 + [_INT] * 3 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID],
    ),
    "qp_solve_launch_aa": (
        _INT,
        [_INT] + [_VOID] * 13 + [_INT] * 3 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID] + [_INT, _VOID],
    ),
    "qp_solve_problems_per_block": (_INT, [_INT, _INT]),
    "qp_solve_workspace_floats": (_LL, [_INT, _INT]),
    "spd_inverse_launch": (_INT, [_VOID] * 4 + [_INT] * 3 + [_VOID]),
    "spd_inverse_launch_as": (_INT, [_INT] + [_VOID] * 4 + [_INT] * 3 + [_VOID]),
    "spd_inverse_workspace_floats": (_LL, [_INT]),
    "spd_inverse_workspace_floats_as": (_LL, [_INT, _INT]),
    "spd_inverse_problems_per_block": (_INT, [_INT]),
    "spd_inverse_arm_info": (_INT, [_INT, _INT, _VOID]),
    "admm_chunk_launch": (
        _INT, [_VOID] * 14 + [_INT] * 3 + [_FLOAT] * 2 + [_INT, _INT, _VOID],
    ),
    "admm_chunk_launch_as": (
        _INT, [_INT] * 2 + [_VOID] * 14 + [_INT] * 3 + [_FLOAT] * 2 + [_INT, _INT, _VOID, _VOID],
    ),
    "admm_chunk_route_layout": (_INT, [_INT] * 6 + [_VOID]),
    # the layout reports of a library built before the routes (a parent
    # tree's, tools/kernel_ab.py)
    "admm_chunk_wide_layout": (_INT, [_INT] * 5 + [_VOID]),
    "admm_chunk_smem_rows": (_INT, [_INT, _INT]),
    "admm_chunk_reg_rows": (_INT, [_INT, _INT]),
    "qp_btd_launch": (
        _INT,
        [_VOID] * 15 + [_INT] * 4 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID],
    ),
    "qp_btd_launch_as": (
        _INT,
        [_INT] + [_VOID] * 15 + [_INT] * 4 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID],
    ),
    "qp_btd_launch_aa": (
        _INT,
        [_INT] + [_VOID] * 15 + [_INT] * 4 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID] + [_INT, _VOID],
    ),
    # the wide kernel's entries of a library built before the compact route
    # (a parent tree's, tools/kernel_ab.py): its layout reports and launches
    "qp_btd_wide_launch": (
        _INT,
        [_VOID] * 15 + [_INT] * 4 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID] + [_VOID, _VOID],
    ),
    "qp_btd_wide_launch_aa": (
        _INT,
        [_VOID] * 15 + [_INT] * 4 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID] + [_VOID, _VOID] + [_INT, _VOID],
    ),
    "qp_btd_wide_layout": (_INT, [_INT] * 3 + [_VOID]),
    "qp_btd_wide_layout_aa": (_INT, [_INT] * 4 + [_VOID]),
    # the wide kernel's entries (past internal block 128 with the nonzeros
    # a block holds)
    "qp_btd_wide_launch_nnz": (
        _INT,
        [_VOID] * 15 + [_INT] * 4 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID] + [_VOID, _VOID] + [_VOID],
    ),
    "qp_btd_wide_launch_aa_nnz": (
        _INT,
        [_VOID] * 15 + [_INT] * 4 + [_FLOAT] * 5 + [_INT] * 4
        + [_FLOAT, _INT, _FLOAT, _FLOAT, _INT, _VOID] + [_VOID, _VOID] + [_INT, _VOID, _VOID],
    ),
    "qp_btd_wide_layout_nnz": (_INT, [_INT] * 4 + [_VOID, _VOID]),
    "qp_btd_wide_layout_reserve": (_INT, [_INT] * 3 + [_LL, _VOID, _VOID]),
    "qp_btd_smem_rows": (_INT, [_INT] * 4),
    "qp_btd_cluster_size": (_INT, [_INT] * 4),
    "qp_kernel_error_string": (ctypes.c_char_p, [_INT]),
    "qp_kernel_twin_blocks": (_INT, [_INT] * 4),
    "qp_kernel_aa_workspace_floats": (_LL, [_INT] * 4),
    "qp_kernel_aa_placement": (_INT, [_INT] * 5 + [_VOID]),
    "qp_btd_twin_blocks": (_INT, [_INT] * 5),
    "qp_btd_aa_placement": (_INT, [_INT] * 6 + [_VOID]),
}


def build_dir() -> Path:
    return _PKG.parent / "build" / "torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources(csrc: Path = _CSRC):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def _run_all(cmds) -> list:
    """Run the nvcc commands in parallel; raise with the first failure's
    output.  Returns the seconds each took."""
    t0 = time.perf_counter()

    def run(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(cmds))) as pool:
        done = list(pool.map(run, cmds))
    for cmd, (proc, _) in zip(cmds, done):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    return [sec for _, sec in done]


def _compile(cu, so: Path, flags=()) -> None:
    """Compile the sources ``cu`` into the library ``so``: one nvcc per
    source, all started together, then one link."""
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp_dir:
        objs = [Path(tmp_dir) / f"{p.stem}.o" for p in cu]
        secs = _run_all([[nvcc_path(), *_NVCC_FLAGS, *flags, "-c", "-o", str(o), str(p)]
                         for p, o in zip(cu, objs)])
        last_unit_seconds.clear()
        last_unit_seconds.update({p.name: s for p, s in zip(cu, secs)})
        tmp = Path(tmp_dir) / so.name
        _run_all([[nvcc_path(), *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)


def build_library(csrc: Path, out_dir: Path, flags=()) -> ctypes.CDLL:
    """Build the ``*.cu`` of ``csrc`` with nvcc ``flags`` into ``out_dir``
    (under a name hashed from the sources and flags, so a build is reused
    only for the same sources) and load it.  Binds the C functions of the
    interface that the library has (one built from another tree, or from
    one source alone, may lack some)."""
    global last_build_seconds
    cu, cuh = _sources(csrc)
    digest = hashlib.sha1()
    for p in cu + cuh:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join([*_NVCC_FLAGS, *flags]).encode())
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libqp_kernel_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        t0 = time.perf_counter()
        _compile(cu, so, flags)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is None:
        _lib = build_library(_CSRC, build_dir())
    return _lib
