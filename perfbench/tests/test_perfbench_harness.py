"""The harness: every cell of BENCHMARK.json loads by name, a small run of
each gives a whole result line, and a run whose timed path is broken
underneath comes out not correct, as does the control."""

import dataclasses
import json
import time

import pytest
import torch

from perfbench.control import control_readings
from perfbench.harness import (
    HERE,
    cell_of,
    check_lines,
    handwritten_kernels,
    limits_of,
    metrics_of,
    reader,
    run_cell,
    settings_of,
)

CELLS = ["control12-cold", "control50-cold", "control50-wave"]
NUMBERS = {"wrong_status", "claim_excess", "unsolved_share"}


def test_benchmark_file_names_its_pieces(bench):
    """Each configuration's file, each cell's traffic mix and each metric's
    reader is found by its name; every cell reports setup_s, another
    end-to-end metric and a per-layer one."""
    assert [w["name"] for w in bench["workloads"]] == CELLS
    for c in bench["configs"]:
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg["changed"])
        assert not {"n", "m", "dtype", "limits"} & set(cfg)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(m["name"]))
    for w in bench["workloads"]:
        cell, cfg, mix = cell_of(bench, w["name"])
        settings_of(cfg, mix).validate()
        e2e = [m["name"] for m in metrics_of(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert metrics_of(bench, w["name"], True)
        assert set(limits_of(w["name"])) == NUMBERS
    assert {"qp_btd_wide_kernel", "qp_btd_xwide_kernel"} <= set(handwritten_kernels())


def test_benchmark_file_keeps_the_contract(bench):
    """Names, units, lengths and bounds as the benchmark's contract has them."""
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and 1 <= bench["run_seconds"] <= 51
    layers = {m["layer"] for m in bench["per_layer"]}
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert name.match(entry["name"])
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert layers == {"QP entry", "ADMM solver", "kernels", "device"}
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_small_run(bench, small, cell, trace):
    """A run of the cell at a few states on the CPU: correct, with the
    line's keys in order and its metrics those of the cell."""
    line, notes = run_cell(bench, cell, 2**31 + 17, 0.2, trace, "cpu", time.time(),
                           overrides=small)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == notes["calls"] * 4 and line["failed"] == 0
    want = {m["name"] for m in metrics_of(bench, cell, trace)}
    got = set(line["metrics"])
    # the device's kernels have nothing to read on the CPU
    assert got <= want and ("setup_s" in got if not trace else "admm.iters_mean" in got)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0


def _start_residuals(qp):
    """The residuals of the cold start (x, z, y all 0), as an honest answer
    reports them: r_p = dist(0, [l, u]), r_d = |q|."""
    rp = torch.maximum(qp.l.clamp_min(0.0), (-qp.u).clamp_min(0.0)).amax(-1)
    return rp, qp.q.abs().amax(-1)


def broken(kind):
    """The program's entry with its answers broken where they are produced."""
    from sqp_solver_tpu_torch.parallel.batch import qp_solve_batch

    def entry(qp, settings, impl):
        res = qp_solve_batch(qp, settings, impl=impl)
        x, z, y = res.x.clone(), res.z.clone(), res.y.clone()
        info = res.info
        h = x.shape[0] // 2
        if kind == "state_unchanged":  # the start (zeros) comes back, as solved
            x, z, y = torch.zeros_like(x), torch.zeros_like(z), torch.zeros_like(y)
        elif kind == "half_the_batch":  # half solved, the rest left at the start
            x[h:], z[h:], y[h:] = 0.0, 0.0, 0.0
        elif kind in ("half_out_of_iterations", "start_out_of_iterations"):
            # left at the start and honestly so: out of iterations, with the
            # start's own residuals (half the batch, or all of it)
            k = h if kind == "half_out_of_iterations" else 0
            x[k:], z[k:], y[k:] = 0.0, 0.0, 0.0
            rp, rd = _start_residuals(qp)
            keep = torch.arange(x.shape[0]) < k
            info = dataclasses.replace(
                info, status=torch.where(keep, info.status, 1).to(info.status.dtype),
                res_prim=torch.where(keep, info.res_prim, rp.to(info.res_prim.dtype)),
                res_dual=torch.where(keep, info.res_dual, rd.to(info.res_dual.dtype)))
        elif kind == "all_numerical":  # every problem given up as numerical issues
            info = dataclasses.replace(info, status=torch.full_like(info.status, 3))
        elif kind == "answer_altered":
            x[-1, 0] += 0.05
        elif kind == "status_altered":
            info = dataclasses.replace(info, status=torch.where(
                torch.arange(x.shape[0]) == 1, 5, info.status).to(info.status.dtype))
        return dataclasses.replace(res, x=x, z=z, y=y, info=info)

    return entry


@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_batch", "half_out_of_iterations",
                                  "start_out_of_iterations", "all_numerical", "answer_altered",
                                  "status_altered"])
@pytest.mark.parametrize("cell", ["control12-cold", "control50-wave"])
def test_broken_path_is_not_correct(bench, small, cell, kind):
    line, _ = run_cell(bench, cell, 2**31 + 23, 0.2, False, "cpu", time.time(),
                       entry=broken(kind), overrides=small)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("summary, correct", [
    (dict(wrong_status=0, claim_excess=0.01, unsolved_share=0.0), True),
    (dict(wrong_status=0, claim_excess=None, unsolved_share=0.0), False),
    (dict(wrong_status=0, claim_excess=float("nan"), unsolved_share=0.0), False),
    (dict(wrong_status=0, claim_excess=0.01, unsolved_share=0.5), False),
    (dict(wrong_status=1, claim_excess=0.01, unsolved_share=0.0), False),
], ids=["sound", "no_reading", "nan", "unsolved", "wrong_status"])
def test_check_lines(summary, correct):
    """A number with no reading, or a non-finite one, fails and shows as
    null; every number shows beside its limit."""
    ok, lines = check_lines(summary, limits_of("control12-cold"))
    assert ok is correct and set(lines) == NUMBERS
    json.dumps(lines, allow_nan=False)
    for name, c in lines.items():
        assert c["limit"] == limits_of("control12-cold")[name]


@pytest.mark.parametrize("cell", ["control12-cold", "control50-wave"])
def test_control_is_not_correct(bench, small, cell):
    """The reference in TF32 in the program's place fails the check; in
    float32 and float64 it passes."""
    assert control_readings(bench, cell, 2**31 + 29, 1, "tf32", "cpu",
                            overrides=small)["correct"] is False
    for precision in ("float32", "float64"):
        assert control_readings(bench, cell, 2**31 + 29, 1, precision, "cpu",
                                overrides=small)["correct"] is True
