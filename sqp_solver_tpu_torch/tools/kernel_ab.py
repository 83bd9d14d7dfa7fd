"""This checkout's kernels against another tree's, on the card.

    python -m sqp_solver_tpu_torch.tools.kernel_ab --parent build/parent \
        [--parts bits,time,phases] [--kernels k3,k5] [--memory 40]

``--parent`` is the root of another checkout (for example the parent
commit unpacked with ``git archive`` into ``build/parent``).  Each tree's
kernel sources are built, with that tree's own headers, into libraries
under ``build/kernel_ab/`` (only the sources the parts need, all nvcc
processes started together); the Python around the kernels is this
checkout's, which passes each library to the launchers explicitly and is
valid as long as the C interface of the kernels compared is the same in
both trees.  The parts, in order (``--parts`` picks some):

``bits``    K1, K2, K5 (the wide variant too, at D = 1280 and 2048), K6 and
            K7 (the wide kernel too, at the internal blocks up to 128 of
            ``chip_smoke.btd_wide_cases``) of both trees at their
            ``chip_smoke.py`` shapes, K3 at those shapes (its warp layout)
            and at two that its warp layout does not take (n > 32 or
            m > 64), and K4 at n = 32 (its warp layout), on the same seeded
            inputs, every launch without Anderson acceleration; then the
            Anderson
            instantiations at leg G's shapes and settings
            (``chip_smoke.aa_cases``: K1, K3 in both layouts, K6 and K7 at
            their cells' settings and on a cluster with chunks of 10, K6
            at horizon 32 on one block, the wide K6 and K7, and K1 and the
            K6 cluster at memory 8): every output tensor must be equal bit
            for bit.  K4 at n = 128 sums
            in the blocked order, so there the change alone must have the
            fail flags of ``_chol_inv_blocked`` and of
            ``spd_inverse_reference``, lie within ``chip_smoke.TOL``
            of both, and equal its own two-buffer arm bit for bit;
``regs``    the registers, stack and local (spill) bytes a thread of
            every kernel of both libraries (``cuobjdump
            --dump-resource-usage``, the numbers the runtime's
            ``cudaFuncGetAttributes`` reports): each kernel the parent has
            must use the same in the change, but those this tree redesigned
            (``REDESIGNED``), which are listed beside the parent's;
``time``    milliseconds of the kernels of ``--kernels`` (any of k1, k2,
            k3, k4, k5, k6, k7, and the Anderson instantiations k1aa,
            k3aa, k6aa, k7aa, k6waa and k7waa, the wide K6 and K7, at leg
            G's shapes, and past memory 32 k6xaa, the compact route at
            bb = 256; k6x, k7x, the wide K6 and K7 past internal block
            128) at every ``chip_smoke.py`` shape
            (``chip_smoke.dense_cases`` for K1/K2, ``qp_cases`` for K3,
            ``spd_cases`` for K4, ``chunk_cases`` for K5 at its narrow,
            middle (D = 512, 960: each tree's own route) and wide
            shapes, ``btd_cases`` for K6/K7, ``btd_past128_cases`` for
            k6x/k7x: a tree whose library has no compact route runs its
            own route there), CUDA events, in turns
            parent, change, change,
            parent (K6/K7 also the change in the other block layout);
            with k4, also the host wall of the K4 polish route on the
            one-shot QP cell with each tree's K4 (:func:`polish_route`);
``phases``  the phase split of the same launches: each tree's kernel
            source built with ``-DADMM_PHASE_CLOCKS`` against this
            checkout's headers, whose ``ADMM_PHASE_*`` marks bound the
            phases (a tree whose kernel source has no marks of its own
            gets only those of the shared pieces it calls), one launch per
            shape after a warm-up; thread 0 of each block sums the
            clock64() spans of each phase (``PHASES``), reported in cycles
            per block (under K3's warp layout, those of the block's first
            problem; for the wide K5 also per iteration).  A tree whose
            source has no marks at all (K5 before they were added) gets no
            split.  The Anderson units build against their tree's own
            headers, since the step they time lives in ``admm_core.cuh``,
            beside the units they include (each unit reads its own sums:
            an Anderson unit's reader is ``admm_phase_clocks_aa``), and
            each split is also given per chunk.

``--memory M`` adds leg G's cases past memory 32 (``chip_smoke.aa_memory_cases``:
            K1, K3 in both layouts, the K6 and K7 clusters and the wide K6
            and K7 at chunks of 2 and rho every 120) at memory M to
            ``bits``, and gives ``time`` and ``phases`` those cases in
            place of the memory-4 ones (each timed row with the change's
            memory-4 launch beside it).

``placements`` K1 and K3 in both layouts with Anderson at memories 33, 40, 64
            and 128 (``--memories``; leg G's shapes and settings past 32)
            with every placement of the chunk's system forced by a build
            of this checkout's Anderson unit with ``-DAA_FORCE_SOLVE=p``
            (``FORCED``: the whole Gram area on chip, a solve area a
            problem, one a block, the workspace), in turns rule, forced
            ..., forced reversed, rule: each forced launch bit for bit the
            rule's (the same arithmetic), its placement as its launcher
            reports it (a placement that shared memory cannot hold is
            refused and listed), and the ms of each.  With the structured
            keys in ``--kernels`` (k6aa, k7aa, k6waa, k7waa, k6xaa) those
            kernels, their units built with the kept Gram's and the
            system's placements forced (``FORCED_BTD``, ``-DAA_FORCE_SOLVE``
            and ``-DAA_FORCE_GRAM``).

``k5rows``  K5 at the middle sizes (``chip_smoke.CHUNK_MID_SHAPES``,
            D = 512 and 960) through ``chip_smoke.compare_chunk`` with each
            tree of ``--trees``' library: against its plain version, the
            kernel's and the plain version's ms, the bound, the streaming
            floor, the route, the rows of W on chip and the bytes of W read
            from device memory an iteration (a tree before the routes: its
            one block a problem).

The last line of the output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the AdmmPhase enum of csrc/admm_core.cuh, in its order
PHASES = ("gram", "thomas", "atmv", "sweep", "amv", "stats", "total",
          "chol", "linv", "ltl", "bfgs", "polish", "load", "cert", "iter",
          "ring", "dot", "exchange", "aaring", "aadot", "aasolve", "aacand",
          "aarevert")
# the Anderson step's parts
AA_PHASES = ("aaring", "aadot", "aasolve", "aacand", "aarevert")
SOURCES = {"k1": "qp_kernel.cu", "k2": "qp_kernel.cu", "k3": "qp_kernel.cu",
           "k4": "qp_kernel.cu", "k5": "admm_kernel.cu", "k6": "qp_kernel_btd.cu",
           "k7": "qp_kernel_btd.cu", "k1aa": "qp_kernel_aa.cu", "k3aa": "qp_kernel_aa.cu",
           "k6aa": "qp_kernel_btd_aa.cu", "k7aa": "qp_kernel_btd_aa.cu",
           "k6waa": "qp_kernel_btd_wide_aa.cu", "k7waa": "qp_kernel_btd_wide_aa.cu",
           "k6xaa": "qp_kernel_btd_wide_aa.cu", "k6x": "qp_kernel_btd_wide.cu",
           "k7x": "qp_kernel_btd_wide.cu"}
# the Anderson units, each with the unit it includes (whose C functions it
# calls): a library holds both
TWINS = {"qp_kernel_aa.cu": "qp_kernel.cu", "qp_kernel_btd_aa.cu": "qp_kernel_btd.cu",
         "qp_kernel_btd_wide_aa.cu": "qp_kernel_btd_wide.cu"}
# the structured Anderson units' second units, whose kernels take the
# launches whose chunk system is off the Gram area (past memory 32): a
# library of a tree that has them holds them beside the Anderson unit
SYS_UNITS = {"qp_kernel_btd_aa.cu": "qp_kernel_btd_aas.cu",
             "qp_kernel_btd_wide_aa.cu": "qp_kernel_btd_wide_aas.cu"}
AA_KERNELS = ("k1aa", "k3aa", "k6aa", "k7aa", "k6waa", "k7waa", "k6xaa")
# the phase-clock readers of the Anderson units and their second units
AA_READERS = ("admm_phase_clocks_aa", "admm_phase_clocks_aas")
# the placements of K1's and K3's chunk system past memory 32 that
# ``placements`` forces (-DAA_FORCE_SOLVE=p: csrc/qp_kernel.cu:aa_dense_plan)
FORCED = {0: "gram", 1: "scope", 2: "block", 3: "workspace"}
# the structured kernels' placements past memory 32 that ``placements``
# forces (-DAA_FORCE_SOLVE=p -DAA_FORCE_GRAM=g: csrc/qp_kernel_btd.cu:
# btd_aa_plan, qp_kernel_btd_wide.cu:wide_aa_plan): the parent's whole Gram
# area on chip with the system in it (solved by rows), the kept Gram and a
# solve area both on chip, the solve area alone, the Gram area alone (the
# system in the workspace), and both in the workspace
FORCED_BTD = {"gram": (0, 1), "gram+scope": (1, 1), "scope": (1, 0),
              "gram+workspace": (3, 1), "workspace": (3, 0)}
PLACEMENT_MEMORIES = (33, 40, 64, 128)
# the kernels that ``bits`` holds equal to the parent's, and the Anderson
# instantiations at leg G's shapes
BITS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7") + AA_KERNELS
# kernels (and device functions of their own) of the parent that this tree
# changed: ``regs`` lists them and does not hold them to the parent's
# registers.  None: the compact route past internal block 128 is kernels of
# its own (qp_btd_xwide_kernel and its Anderson instantiation, which
# ``regs`` lists as new), and every kernel of the parent keeps its registers
REDESIGNED = ()


def _csrc(tree: Path) -> Path:
    return tree / "sqp_solver_tpu_torch" / "csrc"


def _stage_and_build(cu: list, headers: Path, label: str, flags=()):
    """Copy the sources ``cu`` and the ``*.cuh`` of ``headers`` into
    ``build/kernel_ab/<label>`` and build them into one library there."""
    from sqp_solver_tpu_torch.ops import _build

    out = _build.build_dir().parent / "kernel_ab" / label
    csrc = out / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    csrc.mkdir(parents=True)
    for p in cu:
        shutil.copy(p, csrc / p.name)
    for h in headers.glob("*.cuh"):
        shutil.copy(h, csrc / h.name)
    lib = _build.build_library(csrc, out, flags=flags)
    for reader in ("admm_phase_clocks", "admm_phase_clocks_aa", "admm_phase_clocks_aas"):
        if "-DADMM_PHASE_CLOCKS" in flags and hasattr(lib, reader):
            getattr(lib, reader).restype = ctypes.c_int
            getattr(lib, reader).argtypes = [ctypes.c_void_p]
    return lib


def with_twins(sources) -> list:
    """The sources with the unit each Anderson unit includes, sorted."""
    return sorted(set(sources) | {TWINS[s] for s in sources if s in TWINS})


def tree_units(tree: Path, sources) -> list:
    """:func:`with_twins` of ``sources`` and the second units
    (``SYS_UNITS``) of its structured Anderson units that ``tree`` has."""
    units = with_twins(sources)
    return sorted(set(units) | {SYS_UNITS[s] for s in units
                                if s in SYS_UNITS and (_csrc(tree) / SYS_UNITS[s]).exists()})


def kernel_library(tree: Path, label: str, sources, flags=()) -> ctypes.CDLL:
    """``tree``'s kernel sources (names in its ``csrc``) with its own headers
    (and nvcc ``flags``)."""
    return _stage_and_build([_csrc(tree) / s for s in tree_units(tree, sources)], _csrc(tree),
                            label, flags=flags)


def phase_library(tree: Path, label: str, source: str) -> ctypes.CDLL:
    """``tree``'s kernel source with phase clocks, against this checkout's
    headers; an Anderson unit (with the unit it includes) against the
    tree's own, which hold the step it times."""
    headers = _csrc(tree) if source in TWINS else _csrc(ROOT)
    return _stage_and_build([_csrc(tree) / s for s in tree_units(tree, [source])], headers,
                            f"{label}-phases", flags=("-DADMM_PHASE_CLOCKS",))


def forced_library(p: int) -> ctypes.CDLL:
    """This checkout's Anderson unit (with the unit it includes) built with
    its placement past memory 32 forced to ``FORCED[p]``."""
    return _stage_and_build([_csrc(ROOT) / s for s in with_twins(["qp_kernel_aa.cu"])],
                            _csrc(ROOT), f"force-{FORCED[p]}", flags=(f"-DAA_FORCE_SOLVE={p}",))


def forced_btd_library(label: str) -> ctypes.CDLL:
    """This checkout's structured Anderson units (with the units they
    include and their second units) built with their placement past memory
    32 forced to ``FORCED_BTD[label]``."""
    p, g = FORCED_BTD[label]
    units = tree_units(ROOT, ["qp_kernel_btd_aa.cu", "qp_kernel_btd_wide_aa.cu"])
    return _stage_and_build([_csrc(ROOT) / s for s in units], _csrc(ROOT), f"force-btd-{label}",
                            flags=(f"-DAA_FORCE_SOLVE={p}", f"-DAA_FORCE_GRAM={g}"))


def build_all(jobs: dict) -> dict:
    """Run the library builds ``{key: (fn, *args)}`` at once (each nvcc is a
    process of its own; the threads only wait on them)."""
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        futs = {k: pool.submit(fn, *args) for k, (fn, *args) in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def clock_split(lib, launch, blocks: int, reader="admm_phase_clocks"):
    """(cycles per block of each marked phase, the output) of one
    ``launch()`` after a warm-up launch, from a ``-DADMM_PHASE_CLOCKS``
    library: the sums of the unit whose reader is ``reader`` (an Anderson
    unit's: ``admm_phase_clocks_aa``), or of the units of a tuple of
    readers that the library has (``AA_READERS``)."""
    import numpy as np
    import torch

    names = reader if isinstance(reader, tuple) else (reader,)
    reads = [getattr(lib, r) for r in names if hasattr(lib, r)]
    bufs = [np.zeros(len(PHASES), dtype=np.uint64) for _ in reads]
    launch()
    rc = 0
    for read, buf in zip(reads, bufs):
        rc = rc or read(buf.ctypes.data)
    out = launch()
    torch.cuda.synchronize()
    for read, buf in zip(reads, bufs):
        rc = rc or read(buf.ctypes.data)
    if rc or not reads:
        raise RuntimeError(f"admm_phase_clocks failed ({rc}; readers {names})")
    buf = sum(bufs)
    return {p: float(buf[i]) / blocks for i, p in enumerate(PHASES) if buf[i]}, out


def format_split(cyc: dict) -> str:
    total = cyc.get("total")
    return ", ".join(f"{p} {v:.0f}" + (f" ({v / total:.3f})" if total and p != "total" else "")
                     for p, v in cyc.items())


def _tensors(out) -> dict:
    import torch

    if isinstance(out, tuple) and not hasattr(out, "_asdict"):
        return {str(i): v for i, v in enumerate(out)}
    return {k: v for k, v in out._asdict().items() if isinstance(v, torch.Tensor)}


def same_bits(a, b) -> bool:
    """Equal bit for bit: float tensors by their bit patterns, so that the
    NaN a failed factor leaves in an output equals the same NaN."""
    import torch

    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def bits(libs: dict, dev, memory_cases=()) -> list:
    """K1, K2, K5 (the wide variant too), K6 and K7 (the wide kernel too, at
    internal blocks up to 128) of both trees at their ``chip_smoke.py``
    shapes,
    K3 at its ``chip_smoke.py`` shapes (the warp layout) and at two outside
    its warp layout (n > 32 or m > 64), K4 at n = 32 and the Anderson
    instantiations at leg G's shapes (``chip_smoke.aa_cases``), on the same
    inputs; raises unless every output is equal bit for bit.  Then K4 at
    n = 128 (:func:`blocked_k4`)."""
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.models.mpc import random_qp_batch
    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    cases = [(c["label"], c["launch"]) for c in cs.dense_cases(dev)]
    cases += [(f"{c['label']} (warp layout)", c["launch"]) for c in cs.qp_cases(dev)]
    for batch, n, m in ((1024, 64, 65), (1024, 32, 80)):
        qp = random_qp_batch(batch, n, m, seed=n + m, device=dev)
        t = {k: getattr(qp, k) for k in cs.LEAVES}
        t.update(x=torch.zeros((batch, n), device=dev), z=torch.zeros((batch, m), device=dev),
                 y=torch.zeros((batch, m), device=dev))
        for label, qs in (("one epoch", cs.qp_bench_settings(adaptive_rho=False)),
                          ("4 epochs", cs.qp_bench_settings())):
            cases.append((f"K3 random n={n} m={m} B={batch} {label}",
                          lambda lib, t=t, qs=qs: cs.qp_raw(
                              lambda *a: qk._qp_solve_launch(*a, lib=lib), t, qs)))
    cases += [(c["label"], c["launch"]) for c in cs.spd_cases(dev) if c["n"] <= 32]
    cases += [(c["label"], c["launch"]) for c in cs.chunk_cases(dev)]
    cases += [(c["label"], c["launch"]) for c in cs.chunk_cases(dev, cs.CHUNK_WIDE_SHAPES)]
    for c in cs.btd_cases(dev) + [c for c in cs.btd_wide_cases(dev) if c["bb"] <= 128]:
        cases.append((c["label"], lambda lib, c=c: cs.btd_launch(
            c["t"], c["settings"], c["check_infeas"], lib=lib)))
    cases += [(c["label"], c["launch"]) for c in list(cs.aa_cases(dev)) + list(memory_cases)]
    rows = []
    for label, fn in cases:
        outs = {who: _tensors(fn(lib)) for who, lib in libs.items()}
        torch.cuda.synchronize()
        differ = [k for k, v in outs["parent"].items() if not same_bits(v, outs["change"][k])]
        cs.log(f"  {label}: {len(outs['parent'])} outputs, "
               f"{'bit for bit equal' if not differ else 'DIFFER: ' + ', '.join(differ)}")
        if differ:
            raise AssertionError(f"{label}: outputs differ from the parent's: {differ}")
        rows.append(dict(case=label, outputs=len(outs["parent"]), equal=True))
    rows.append(blocked_k4(libs["change"], dev))
    return rows


def resource_usage(lib) -> dict:
    """{kernel: {REG, STACK, LOCAL, SHARED}} of every kernel in the library
    ``lib`` (a ``ctypes.CDLL``), from ``cuobjdump --dump-resource-usage``."""
    import re
    import subprocess

    from sqp_solver_tpu_torch.ops import _build

    tool = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    out = subprocess.run([tool, "--dump-resource-usage", lib._name], capture_output=True,
                         text=True, check=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            # a kernel in an anonymous namespace carries a hash of its
            # translation unit in its name, which differs between trees
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}", r"_GLOBAL__N__\1",
                          m.group(1))
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                            line)}
            name = None
    return usage


def regs(libs: dict) -> list:
    """Each kernel of the parent's library against the same kernel of the
    change's: equal registers, stack and local bytes a thread, or raise."""
    import chip_smoke as cs

    use = {who: resource_usage(lib) for who, lib in libs.items()}
    rows, differ = [], []
    for name, u in sorted(use["parent"].items()):
        v = use["change"].get(name)
        redesigned = any(k in name for k in REDESIGNED)
        if v != u and not redesigned:
            differ.append(name)
        note = "  redesigned" if redesigned else "" if v == u else "  DIFFER"
        cs.log(f"  {name[:72]}: parent {u}, change {v}{note}")
        rows.append(dict(kernel=name, parent=u, change=v, redesigned=redesigned))
    for name in sorted(set(use["change"]) - set(use["parent"])):
        cs.log(f"  {name[:72]}: new in the change, {use['change'][name]}")
        rows.append(dict(kernel=name, change=use["change"][name]))
    if differ:
        raise AssertionError(f"resource usage differs from the parent's: {differ}")
    return rows


def blocked_k4(lib, dev) -> dict:
    """K4 of ``lib`` at n = 128, which sums in the blocked order: its fail
    flags must equal those of the plain twin of that order
    (``_chol_inv_blocked``) and of the plain version
    (``spd_inverse_reference``), its Minv lie within ``chip_smoke.TOL``
    of both on the problems that do not fail, and its outputs equal bit
    for bit those of ``lib``'s two-buffer arm (K1's calls of the blocked
    factor, whose order the twin follows)."""
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    c = [c for c in cs.spd_cases(dev) if c["n"] > 32][0]
    M = cs.spd_operands(c["batch"], c["n"], dev)
    Minv, fail = c["launch"](lib)
    errs = {}
    for label, (ref, rfail) in (("_chol_inv_blocked", qk._chol_inv_blocked(M)),
                                ("spd_inverse_reference", qk.spd_inverse_reference(M))):
        torch.cuda.synchronize()
        if not torch.equal(fail, rfail):
            raise AssertionError(f"{c['label']}: fail flags differ from {label}'s")
        good = ~rfail
        errs[label] = cs.check_close(f"{c['label']} against {label}", Minv[good], ref[good])
    two = qk._spd_inverse_launch(M, lib=lib, arm="two-buffer")
    differ = [k for k, a, b in zip(("Minv", "fail"), (Minv, fail), two) if not same_bits(a, b)]
    if differ:
        raise AssertionError(f"{c['label']}: {differ} differ from the two-buffer arm's")
    cs.log(f"  {c['label']} (blocked order): fail flags equal, max |change - "
           + ", ".join(f"{k}| {v:.3e}" for k, v in errs.items())
           + "; bit for bit the two-buffer arm")
    return dict(case=c["label"], fail_equal=True, max_abs_err=errs, two_buffer_equal=True)


def _turns(libs: dict, launch, reps: int, other=None) -> dict:
    """ms of ``launch(lib, cluster)`` in turns parent, change, [other,
    other,] change, parent, listed by turn."""
    import chip_smoke as cs

    turns = ["parent", "change"] + ["other"] * 2 * (other is not None) + ["change", "parent"]
    ms = {who: [] for who in turns}
    for who in turns:
        lib = libs["parent" if who == "parent" else "change"]
        ms[who].append(cs.cuda_ms(lambda: launch(lib, other if who == "other" else None), reps))
    return ms


def timing(libs: dict, dense: list, btd: list) -> list:
    """K1-K5 and K6/K7 ms of both trees at each shape, in turns parent,
    change, change, parent; for K6/K7, between the change's turns, two
    turns of the change with the other number of blocks per problem, where
    it has one."""
    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb

    rows = []
    for c in dense:
        ms = _turns(libs, lambda lib, _: c["launch"](lib), c["reps"])
        mean = {who: sum(v) / len(v) for who, v in ms.items()}
        # an Anderson case: the change's same launch without Anderson, after the turns
        none = cs.cuda_ms(lambda: c["launch_none"](libs["change"]), c["reps"]) if (
            "launch_none" in c) else None
        cs.log(f"  {c['label']}: parent {mean['parent']:.3f} ms, change {mean['change']:.3f} ms, "
               f"parent / change {mean['parent'] / mean['change']:.2f}x (means of 2 turns of "
               f"{c['reps']} launches: {ms})"
               + ("" if none is None else
                  f"; {c.get('none_label', 'without Anderson')} {none:.3f} ms"))
        rows.append(dict(case=c["label"], n=c["n"], batch=c["batch"], parent_ms=mean["parent"],
                         change_ms=mean["change"], speedup=mean["parent"] / mean["change"],
                         turns=ms, none_ms=none))
    for c in btd:
        reps = 3 if "random" in c["label"] else 5
        rule = qb.cluster_size(c["n"], c["m"], c["bb"], c["batch"], lib=libs["change"],
                               nnz=cs.btd_nnz(c))
        other = 3 - rule if c["bb"] <= 16 else None
        ms = _turns(libs, lambda lib, cl: cs.btd_launch(c["t"], c["settings"], c["check_infeas"],
                                                        cluster=cl, lib=lib), reps, other)
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


def polish_route(libs: dict, dev, runs: int = 5) -> dict:
    """The K4 polish route on ``chip_smoke.py``'s one-shot QP cell (random
    QPs n = 32, m = 33, B = 4096, solved once by K3; then
    ``polish_qp(use_kernel=False)``, two passes, each one K4 launch and
    plain PyTorch ops) with each tree's K4, in turns parent, change, change,
    parent: the host wall closed by a synchronize, the median of ``runs``
    runs a turn."""
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.models.mpc import random_qp_batch
    from sqp_solver_tpu_torch.ops import qp_kernel as qk
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch
    from sqp_solver_tpu_torch.qp.polish import polish_qp

    s = cs.qp_bench_settings()
    qp = random_qp_batch(4096, 32, 33, seed=0, device=dev)
    res = qp_solve_batch(qp, s, impl="kernel")
    package_library = qk._library
    walls = {"parent": [], "change": []}
    try:
        for who in ("parent", "change", "change", "parent"):
            qk._library = lambda lib=libs[who]: lib  # the route's K4 launch takes this tree's
            polish_qp(qp, res, s, use_kernel=False)  # warm-up
            runs_ms = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                polish_qp(qp, res, s, use_kernel=False)
                torch.cuda.synchronize()
                runs_ms.append((time.perf_counter() - t0) * 1e3)
            walls[who].append(float(np.median(runs_ms)))
    finally:
        qk._library = package_library
    mean = {who: sum(v) / len(v) for who, v in walls.items()}
    cs.log(f"  K4 polish route, one-shot QP n=32 m=33 B=4096, {s.polish_passes} passes: parent "
           f"{mean['parent']:.3f} ms, change {mean['change']:.3f} ms (host wall, medians of "
           f"{runs} runs a turn: {walls})")
    return dict(case="K4 polish route n=32 m=33 B=4096", parent_ms=mean["parent"],
                change_ms=mean["change"], turns=walls)


def placements(libs: dict, forced: dict, dev, memories=PLACEMENT_MEMORIES,
               keys=("k1aa", "k3aa")) -> list:
    """Leg G's Anderson cases past memory 32 whose ``tools/kernel_ab.py``
    key is one of ``keys`` (K1 and K3 in both layouts by default; k6aa,
    k7aa, k6waa, k7waa, k6xaa the structured kernels) at each of
    ``memories`` (``chip_smoke.aa_memory_cases``) on the change's library
    (the rule) and on each forced build (``forced``: {label: library},
    ``FORCED``'s labels for K1 and K3, ``FORCED_BTD``'s for the structured
    kernels), in turns rule, forced in their order, then reversed, rule:
    the ms of each, the placement its launcher reports, and its outputs bit
    for bit the rule's (raises where they differ).  A forced placement that
    shared memory cannot hold is refused by its launcher and listed as
    refused."""
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel as qk

    long_cases = [c for c in cs.aa_long_cases(dev, libs["change"])
                  if (c.get("key") or cs.AA_LONG_KEYS[c["kernel"]]) in keys]
    rows = []
    for memory in memories:
        for c in cs.aa_memory_cases(dev, memory, long_cases):
            where = {"rule": libs["change"], **forced}
            placed, ref = {}, _tensors(c["launch"](libs["change"]))
            kw = dict(bb=c.get("bb"), cluster=c.get("cluster"), nnz=c.get("nnz"))
            for who, lib in where.items():
                try:
                    placed[who] = qk.anderson_placement_card(c["placement"], c["n"], c["m"],
                                                             memory, lib=lib, **kw)
                    out = _tensors(c["launch"](lib))
                except (RuntimeError, ValueError) as err:  # the launcher refuses what does not fit
                    placed[who] = f"refused: {err}"
                    continue
                torch.cuda.synchronize()
                differ = [k for k, v in ref.items() if not same_bits(v, out[k])]
                if differ:
                    raise AssertionError(f"{c['label']}, {who}: {differ} differ from the rule's")
            ran = [who for who in where if isinstance(placed[who], dict)]
            ms = {who: [] for who in ran}
            for who in ran + ran[::-1]:
                ms[who].append(cs.cuda_ms(lambda: c["launch"](where[who]), c["reps"]))
            mean = {who: sum(v) / len(v) for who, v in ms.items()}

            def where_is(pl):
                return (f"{'Gram area on chip' if pl['gram'] else 'Gram area in the workspace'}, "
                        f"system {pl['solve']}"
                        + (f", {pl['blocks']} blocks an SM" if "blocks" in pl else ""))

            rule = placed["rule"]
            cs.log(f"  {c['label']}: the rule's ({where_is(rule)}"
                   + (f", the twin {rule['twin_blocks']}" if "twin_blocks" in rule else "")
                   + f") {mean['rule']:.3f} ms; "
                   + ", ".join(f"{who} {mean[who]:.3f} ms ({where_is(placed[who])})"
                               if who in mean else f"{who} refused"
                               for who in where if who != "rule")
                   + " [bit for bit the rule's]")
            rows.append(dict(case=c["label"], kernel=c["placement"], memory=memory,
                             rule=rule["solve"], gram=rule["gram"], placements=placed, ms=mean,
                             turns=ms))
    return rows


def aa_split(lib, c: dict) -> dict:
    """The phase split of one Anderson case ``c`` (``chip_smoke.aa_cases``)
    from the phase-clock build ``lib``: cycles per block, and the step's
    parts (``AA_PHASES``) and the chunk-end stats per chunk (chunks: the
    mean iterations over the chunk length)."""
    cyc, out = clock_split(lib, lambda: c["launch"](lib), c["blocks"], reader=AA_READERS)
    chunks = float(out.iter.double().mean()) / c["seg"]
    per_chunk = {p: cyc.get(p, 0.0) / max(chunks, 1.0) for p in ("stats",) + AA_PHASES}
    return dict(cycles_per_block=cyc, chunks=chunks, cycles_per_chunk=per_chunk,
                step_per_chunk=sum(per_chunk[p] for p in AA_PHASES))


def phases(phase_libs: dict, dense: list, btd: list, aa: list = ()) -> list:
    """Per-block clock64() cycles of each phase, one launch per shape and tree."""
    import chip_smoke as cs

    rows = []
    for c in aa:
        for who, lib in phase_libs[SOURCES[c["kernel"]]].items():
            r = aa_split(lib, c)
            cs.log(f"  {c['label']} {who} ({c['blocks']} blocks, {r['chunks']:.1f} chunks): the "
                   f"step {r['step_per_chunk']:.0f} cycles a chunk ("
                   + ", ".join(f"{p[2:]} {r["cycles_per_chunk"][p]:.0f}" for p in AA_PHASES)
                   + f"; the plain stats {r['cycles_per_chunk']['stats']:.0f}); cycles per block "
                   f"{format_split(r['cycles_per_block'])}")
            rows.append(dict(case=c["label"], tree=who, **r))
    for c in dense:
        for who, lib in phase_libs[SOURCES[c["kernel"].lower()]].items():
            if not hasattr(lib, "admm_phase_clocks"):
                cs.log(f"  {c['label']} {who}: the source has no phase marks")
                continue
            blocks = cs.blocks_of(lib, c["kernel"], c["batch"], c["n"], c.get("m", c["n"]))
            cyc, _ = clock_split(lib, lambda: c["launch"](lib), blocks)
            per_iter = {k: v / c["seg"] for k, v in cyc.items()
                        if k in ("ring", "dot", "exchange", "iter")} if c.get("seg") else {}
            cs.log(f"  {c['label']} {who} ({blocks} blocks): cycles per block "
                   f"{format_split(cyc)}" + ("; per iteration " + ", ".join(
                       f"{k} {v:.0f}" for k, v in per_iter.items()) if per_iter else ""))
            rows.append(dict(case=c["label"], tree=who, blocks=blocks, cycles_per_block=cyc,
                             cycles_per_iteration=per_iter))
    for c in btd:
        for who, lib in phase_libs["qp_kernel_btd.cu"].items():
            per = int(lib.qp_btd_cluster_size(c["n"], c["m"], c["bb"], c["batch"]))
            cyc, out = clock_split(lib, lambda: cs.btd_launch(
                c["t"], c["settings"], c["check_infeas"], lib=lib), per * c["batch"])
            iters = float(out.iter.double().mean())
            per_iter = {p: cyc.get(p, 0.0) / max(iters, 1.0) for p in ("atmv", "sweep", "amv")}
            cs.log(f"  {c['label']} {who} ({per} block(s) per problem, mean {iters:.1f} "
                   f"iterations): cycles per block {format_split(cyc)}; per iteration "
                   + ", ".join(f"{p} {v:.0f}" for p, v in per_iter.items()))
            rows.append(dict(case=c["label"], tree=who, blocks_per_problem=per,
                             mean_iter=iters, cycles_per_block=cyc,
                             cycles_per_iteration=per_iter))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--parts", default="bits,time,phases")
    ap.add_argument("--kernels", default="k3,k5")
    ap.add_argument("--trees", default="parent,change",
                    help="the trees whose phase split ``phases`` takes")
    ap.add_argument("--memory", type=int, default=None,
                    help="leg G's Anderson cases at this memory (past 32) for bits, time, phases")
    ap.add_argument("--memories", default=",".join(map(str, PLACEMENT_MEMORIES)),
                    help="the memories of ``placements``")
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
    kernels = args.kernels.split(",")
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    timed = {SOURCES[k] for k in kernels}
    jobs = {}
    split_trees = args.trees.split(",")
    # the placements' cases: K1 and K3 unless --kernels names Anderson keys
    place_keys = [k for k in kernels if k in AA_KERNELS] or ["k1aa", "k3aa"]
    dense_keys = {"k1aa", "k3aa"} & set(place_keys)
    if {"bits", "time", "regs", "k5rows"} & set(parts):
        sources = (timed if "time" in parts else set()) | (
            {SOURCES[k] for k in BITS} if {"bits", "regs"} & set(parts) else set()) | (
            {SOURCES["k5"]} if "k5rows" in parts else set()) | (
            {SOURCES[k] for k in place_keys} if "placements" in parts else set())
        for who, tree in trees.items():
            if {"bits", "time", "regs"} & set(parts) or who in split_trees:
                jobs[who] = (kernel_library, tree, who, sources)
    if "placements" in parts:
        if dense_keys:
            for p in FORCED:
                jobs[("force", FORCED[p])] = (forced_library, p)
        if set(place_keys) - dense_keys:
            for label in FORCED_BTD:
                jobs[("force", label)] = (forced_btd_library, label)
        if "change" not in jobs:
            jobs["change"] = (kernel_library, ROOT, "change", {SOURCES[k] for k in place_keys})
    if "phases" in parts:
        for src in timed:
            for who, tree in trees.items():
                if who not in split_trees:
                    continue
                jobs[(src, who)] = (phase_library, tree, f"{who}-{Path(src).stem}", src)
    built = build_all(jobs)
    libs = {who: built[who] for who in trees if who in built}
    dense = []
    if {"k1", "k2"} & set(kernels):
        dense += [c for c in cs.dense_cases(dev) if c["kernel"].lower() in kernels]
    if "k3" in kernels:
        dense += cs.qp_cases(dev)
    if "k4" in kernels:
        dense += cs.spd_cases(dev)
    if "k5" in kernels:
        dense += [c for shapes in (cs.CHUNK_SHAPES, cs.CHUNK_MID_SHAPES, cs.CHUNK_WIDE_SHAPES)
                  for c in cs.chunk_cases(dev, shapes)]
    btd = cs.btd_cases(dev) if {"k6", "k7"} & set(kernels) else []
    btd = [c for c in btd if c["label"][:2].lower() in kernels]
    if {"k6x", "k7x"} & set(kernels):
        btd += [c for c in cs.btd_past128_cases(dev) if c["label"][:2].lower() + "x" in kernels]
    # a library with the wide kernel's layout report gives the compact
    # route's cluster (else the package's is built)
    wide_lib = next((lib for lib in built.values() if hasattr(lib, "qp_btd_wide_layout_nnz")),
                    None)
    memory_cases = cs.aa_memory_cases(dev, args.memory, lib=wide_lib) if args.memory else []
    aa = [c for c in (memory_cases or cs.aa_cases(dev)) if c["kernel"] in kernels] if set(
        AA_KERNELS) & set(kernels) else []
    result = dict(card=card)
    if "bits" in parts:
        cs.log("K1, K2, K3 in both layouts, K4 at n = 32, K5, K6 and K7, and the Anderson "
               "instantiations at leg G's shapes"
               + (f" and at memory {args.memory}" if args.memory else "")
               + ", parent against change:")
        result["bits"] = bits(libs, dev, memory_cases)
    if "regs" in parts:
        cs.log("registers, stack and local bytes a thread, parent against change:")
        result["regs"] = regs(libs)
    if "time" in parts:
        cs.log(f"{', '.join(k.upper() for k in kernels)} ms at the chip_smoke.py shapes:")
        result["time"] = timing(libs, dense + aa, btd)
        if "k4" in kernels:
            result["polish_route"] = polish_route(libs, dev)
    if "placements" in parts:
        cs.log(f"{', '.join(place_keys)} with Anderson past memory 32, the rule's placement "
               "against each forced one:")
        forced = {label: built[("force", label)] for label in
                  ([FORCED[p] for p in FORCED] if dense_keys else [])
                  + (list(FORCED_BTD) if set(place_keys) - dense_keys else [])}
        memories = [int(k) for k in args.memories.split(",")]
        result["placements"] = []
        if dense_keys:
            result["placements"] += placements(
                libs, {FORCED[p]: forced[FORCED[p]] for p in FORCED}, dev, memories,
                sorted(dense_keys))
        if set(place_keys) - dense_keys:
            result["placements"] += placements(
                libs, {label: forced[label] for label in FORCED_BTD}, dev, memories,
                sorted(set(place_keys) - dense_keys))
    if "k5rows" in parts:
        cs.log("K5 at the middle sizes, each tree's library:")
        result["k5rows"] = {who: [cs.compare_chunk(*shape, dev, reps=4, lib=libs[who])
                                  for shape in cs.CHUNK_MID_SHAPES]
                            for who in split_trees}
    if "phases" in parts:
        cs.log("phase split (clock64, thread 0 of each block):")
        phase_libs = {src: {who: built[(src, who)] for who in split_trees} for src in timed}
        # the split of the narrow K6/K7 (chip_smoke.py splits the wide ones)
        result["phases"] = phases(phase_libs, dense, [c for c in btd if c["bb"] <= 32], aa)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
