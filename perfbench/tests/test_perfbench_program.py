"""What the port records inside itself, read through ``perfbench/program.py``
on the CPU at tiny sizes, in this process.

- the benchmark's own runs (``run.py``, ``harness.run``) leave the port's
  recorder off;
- a traced run through ``program.run`` reads the host-side metrics of
  ``program.ENTRIES`` (the serving copy-in and forward, the loader's
  batch, the train step's phases) and no device metric, and its
  ``idle_by_span`` holds the seconds of ``idle_gaps``;
- ``idle_by_span`` puts each gap under the innermost span of the
  dispatching thread, else under its harness phase;
- every entry keeps the contract's keys and has its reader.
"""
import ast
import os

import pytest

from perfbench import harness, program, trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_layout import NAME, UNIT, _line
from multimodal_learning_tpu_torch.utils import logging as recorder

DEVICE = {"copy_in_gbps.serve", "forward_idle.serve"}


def _run(cell, traced):
    import torch
    torch.set_num_threads(2)
    return program.run(cell, 3000000019, 0.5, traced, tiny.manifest(),
                       device="cpu", scale=tiny.scale(cell))


def _ours(cell):
    return {name for name, *_, cells in program.ENTRIES if cell in cells}


def test_the_benchmarks_own_runs_leave_the_recorder_off():
    tiny.run("pofusion_teacher.serve")
    got = recorder.collect()
    assert got.spans == [] and got.counts == {}


@pytest.mark.parametrize("cell", ["pofusion_teacher.serve",
                                  "pofusion_teacher.train",
                                  "clat_student.train"])
def test_a_traced_run_reads_what_the_port_records(cell):
    r = _run(cell, traced=True)
    assert r["correct"] is True and list(r)[-1] == "check"
    want = _ours(cell) - DEVICE
    assert want and want <= set(r["metrics"])
    assert not DEVICE & set(r["metrics"])
    for name in want:
        assert r["metrics"][name]["value"] >= 0
    if cell.endswith(".serve"):
        m = r["metrics"]
        # the serving call's two parts, inside the harness's own span
        assert m["copy_in_ms.serve"]["value"] \
            + m["forward_dispatch_ms.serve"]["value"] \
            <= m["infer_call_ms.serve"]["value"]
    else:
        assert 0 <= r["metrics"]["batch_ready.train"]["value"] <= 100
    bd = r["breakdown"]
    assert sum(s for _, s in bd["idle_by_span"]) == pytest.approx(
        sum(s for _, s in bd["idle_gaps"]), rel=1e-9)
    assert recorder.collect().spans == []


def test_an_untraced_run_reports_the_end_to_end_metrics_only():
    r = _run("clat_student.serve", traced=False)
    man = program.with_entries(tiny.manifest())
    assert set(r["metrics"]) == {
        m["name"] for m in man["end_to_end"]
        if "clat_student.serve" in m.get("workloads", ["clat_student.serve"])}
    assert "breakdown" not in r


def test_idle_by_span_takes_the_innermost_span_else_the_phase():
    iv = trace.Interval
    tr = trace.Trace(kernels=[iv("k", 1.0, 2.0), iv("k", 4.0, 5.0),
                              iv("k", 7.0, 8.0)],
                     copies=[], phases=[iv("infer_call", 0.0, 6.0),
                                        iv("readback", 6.0, 9.0)],
                     window=(0.0, 9.0))
    ev = program.Event
    prog = program.Program(spans=[], counts={}, dispatch=1, events=[
        ev("serve.infer", 0.0, 6.0, 1), ev("serve.forward", 2.0, 6.0, 1),
        ev("fusion", 2.5, 3.5, 1), ev("serve.forward", 6.0, 9.0, 2)])
    got = dict(program.idle_by_span(tr, prog))
    # gaps 0-1, 2-4, 5-7 and 8-9; the last span runs on another thread
    assert got == {"serve.infer": 1.0,
                   "serve.infer/serve.forward/fusion": 2.0,
                   "serve.infer/serve.forward": 2.0, "readback": 1.0}
    assert sum(got.values()) == sum(s for _, s in trace.idle_gaps(tr))


def test_the_entries_keep_the_contract():
    man = program.with_entries(tiny.manifest())
    e2e = {m["name"] for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    ours = [m for m in man["per_layer"]
            if m["name"] in {e[0] for e in program.ENTRIES}]
    assert len(ours) == len(program.ENTRIES)
    assert not {m["name"] for m in ours} & {
        m["name"] for m in harness.manifest()["per_layer"]}
    for m in ours:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("program_span", "program_counter",
                               "device_trace")
        path = os.path.join(harness.BENCH, "metrics", m["name"] + ".py")
        tree = ast.parse(open(path).read())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body)
