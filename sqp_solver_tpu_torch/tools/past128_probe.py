"""Probes of the wide structured kernel's compact route (internal blocks
past 128), on the card.

    python -m sqp_solver_tpu_torch.tools.past128_probe [--parent build/parent] \
        [--parts levers,phases,agree]

``levers``  every cluster and order of the compact route's rule
            (``ops/qp_kernel_btd.py:COMPACT_CLUSTERS``, A or the matrix slots
            first) forced in turn at ``chip_smoke.btd_past128_cases`` and at
            leg P's shape (K6, B = 128), each by a library of the wide units
            built with ``-DXWIDE_FORCE_CLUSTER`` and ``-DXWIDE_FORCE_ORDER``
            (``csrc/qp_kernel_btd_wide.cu:xwide_rule``): the bytes an ADMM
            iteration reads from device memory and the ms (CUDA events,
            three launches after a warm-up), beside the rule's choice;
``phases``  the wide kernel's phase split (``chip_smoke.wide_phase_split``,
            the source built with ``-DADMM_PHASE_CLOCKS``) at leg P's shape
            (K6, B = 16), its K7 step and K6 at internal block 136: this
            tree's and, with ``--parent``, the parent tree's source (against
            this checkout's headers);
``agree``   the problems whose ADMM iteration count equals the plain
            float32 version's and the plain float64 version's, over twelve
            seeds of random band QPs (``testing.btd_qp_inputs``) at internal
            blocks 136, 152 and 256 with and without Anderson, and the
            largest distance of x from float64: the plain float32 version
            on the card, this tree's kernel and, with ``--parent``, the
            parent tree's (a library of its wide units).

Each line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WIDE_UNITS = ["qp_kernel_btd_wide.cu", "qp_kernel_btd_wide_aa.cu"]


# the forced levers: (cluster, order), order 1 A first, 2 the slots first
LEVERS = [(cl, order) for cl in (2, 4, 8) for order in (1, 2)]


def levers(dev, card: str) -> None:
    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.tools import kernel_ab as ab

    flags = {lv: (f"-DXWIDE_FORCE_CLUSTER={lv[0]}", f"-DXWIDE_FORCE_ORDER={lv[1]}")
             for lv in LEVERS}
    libs = ab.build_all({lv: (ab.kernel_library, ROOT, f"past128-lever-{lv[0]}-{lv[1]}",
                              WIDE_UNITS, f) for lv, f in flags.items()})
    cases = cs.btd_past128_cases(dev) + [cs.btd_control50_case(128, dev)]
    for c in cases:
        nnz = cs.btd_nnz(c)
        rule = qb.wide_layout(c["n"], c["m"], c["bb"], nnz=nnz)
        out = []
        for (cl, order), lib in libs.items():
            lay = qb.wide_layout(c["n"], c["m"], c["bb"], nnz=nnz, lib=lib)
            if (lay["cluster"], lay["a_first"]) != (cl, order == 1):
                raise AssertionError(f"{c['label']}: the build forcing {cl}, {order} took {lay}")
            ms = cs.cuda_ms(lambda lib=lib: cs.btd_launch(c["t"], c["settings"],
                                                          c["check_infeas"], lib=lib), 3)
            out.append(f"{cl} {'A' if order == 1 else 'slots'} first {lay['iter_bytes']} B "
                       f"{ms:.3f} ms")
        cs.log(f"  {c['label']} bb={c['bb']} B={c['batch']} (the rule: {rule['cluster']} "
               f"{'A' if rule['a_first'] else 'slots'} first): " + "; ".join(out) + f" [{card}]")


def phases(dev, card: str, parent) -> None:
    import chip_smoke as cs
    from sqp_solver_tpu_torch.tools import kernel_ab as ab

    trees = {"change": ROOT} if parent is None else {"parent": parent, "change": ROOT}
    libs = ab.build_all({w: (ab.phase_library, t, f"{w}-past128", "qp_kernel_btd_wide.cu")
                         for w, t in trees.items()})
    cases = [cs.btd_control50_case(16, dev), cs.btd_control50_step_case(16, dev)] + [
        c for c in cs.btd_past128_cases(dev) if c["bb"] == 136 and c["label"].startswith("K6")]
    for who, lib in libs.items():
        cs.log(f"  {who}:")
        cs.wide_phase_split(lib, cases, card)


def agree(dev, card: str, parent) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from sqp_solver_tpu_torch.ops import qp_kernel_btd as qb
    from sqp_solver_tpu_torch.testing import btd_qp_inputs
    from sqp_solver_tpu_torch.tools import kernel_ab as ab

    trees = {"change": ROOT} if parent is None else {"parent": parent, "change": ROOT}
    libs = ab.build_all({w: (ab.kernel_library, t, f"{w}-past128", WIDE_UNITS)
                         for w, t in trees.items()})
    base = cs.qp_bench_settings(adaptive_rho=False, linear_solver="schur_block_tridiag")
    for bb, T, m, B, aa in ((256, 2, 200, 8, True), (256, 2, 200, 8, False),
                            (136, 2, 160, 16, True), (152, 2, 150, 16, False)):
        s = dataclasses.replace(base, block_size=bb)
        if aa:
            s = dataclasses.replace(s, check_termination=10, acceleration="anderson",
                                    anderson_memory=3)
        tot = {w: [0, 0, 0.0] for w in (*libs, "plain")}
        for seed in range(12):
            a = cs.to_device(btd_qp_inputs(B, T, bb, m, seed=1000 + seed, dtype=np.float32), dev)
            pd, pe = qb.extract_band(a["P"], bb)
            zx, zm = torch.zeros_like(a["q"]), torch.zeros_like(a["l"])
            args = (pd, pe, a["A"], a["q"], a["l"], a["u"], zx, zm, zm, s)
            p32 = qb.qp_btd_reference(*args, check_infeas=True, band=True)
            p64 = qb.qp_btd_reference(*(v.double() if torch.is_tensor(v) else v for v in args),
                                      check_infeas=True, band=True)
            outs = {w: qb._qp_btd_launch(*args, None, None, True, "past128_probe", lib=lib)
                    for w, lib in libs.items()}
            outs["plain"] = p32
            for w, o in outs.items():
                tot[w][0] += int((o.iter == p32.iter).sum())
                tot[w][1] += int((o.iter == p64.iter).sum())
                tot[w][2] = max(tot[w][2], float((o.x.double() - p64.x).abs().max()))
        cs.log(f"  bb={bb} B={B}{' anderson' if aa else ''}, {12 * B} problems: iterations equal "
               "to plain f32 / f64 (max |x - x64|): "
               + "; ".join(f"{w} {v[0]} / {v[1]} ({v[2]:.2e})" for w, v in tot.items())
               + f" [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--parts", default="levers,phases,agree")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("past128_probe: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    parent = args.parent.resolve() if args.parent else None
    parts = args.parts.split(",")
    if "levers" in parts:
        cs.log("forced clusters and orders past internal block 128:")
        levers(dev, card)
    if "phases" in parts:
        cs.log("the wide kernel's phase split past internal block 128:")
        phases(dev, card, parent)
    if "agree" in parts:
        cs.log("iteration counts against the plain versions over seeds:")
        agree(dev, card, parent)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
