"""What the port records inside itself, read through ``harness.run`` on the
CPU at tiny sizes, in this process.

- untraced runs, which give the end-to-end metrics, leave the port's
  recorder off; traced runs switch it on before set-up and collect it
  back to empty after the window;
- a traced run reads the host-side metrics taken from the recorder (the
  serving copy-in and forward, the loader's batch, the train step's
  phases) and no card-only metric, and its ``idle_by_span`` holds the
  seconds of ``idle_gaps``;
- ``idle_by_span`` puts each gap under the innermost span of the
  dispatching thread, else under its harness phase;
- the copy-in's waits are read per chunk of the window;
- every entry read from the recorder keeps the contract's keys and has
  its reader.
"""
import ast
import importlib.util
import os
from types import SimpleNamespace

import pytest

from perfbench import harness, trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_layout import NAME, UNIT, _line
from multimodal_learning_tpu_torch.utils import logging as recorder

# the metrics read from the port's recorder, and of them those that need
# the card: a device trace, or a counter only the card's copy-in keeps
RECORDED = {"copy_in_ms.serve", "forward_dispatch_ms.serve",
            "copy_in_gbps.serve", "copy_in_waits.serve",
            "forward_idle.serve", "loader_batch_ms.train",
            "batch_ready.train", "forward_dispatch_ms.train",
            "backward_dispatch_ms.train", "optimizer_dispatch_ms.train"}
CARD = {"copy_in_gbps.serve", "copy_in_waits.serve", "forward_idle.serve"}


def _ours(cell):
    return {m["name"] for m in tiny.manifest()["per_layer"]
            if m["name"] in RECORDED and cell in m["workloads"]}


def _watch(monkeypatch):
    """Counts of the recorder's ``enable`` and ``collect`` calls."""
    calls = {"enable": 0, "collect": 0}
    for name in calls:
        real = getattr(recorder, name)

        def wrapped(real=real, name=name):
            calls[name] += 1
            return real()
        monkeypatch.setattr(recorder, name, wrapped)
    return calls


def test_untraced_runs_leave_the_recorder_off(monkeypatch):
    calls = _watch(monkeypatch)
    tiny.run("pofusion_teacher.serve")
    assert calls == {"enable": 0, "collect": 0}
    got = recorder.collect()
    assert got.spans == [] and got.counts == {}


def test_traced_runs_enable_the_recorder_and_collect_it_back_to_empty(
        monkeypatch):
    calls = _watch(monkeypatch)
    r = tiny.run("clat_student.serve", traced=True)
    assert calls == {"enable": 1, "collect": 1}
    assert "copy_in_ms.serve" in r["metrics"]
    assert recorder.span("after") is recorder._NOOP
    got = recorder.collect()
    assert got.spans == [] and got.counts == {}


@pytest.mark.parametrize("cell", ["pofusion_teacher.serve",
                                  "pofusion_teacher.train",
                                  "clat_student.train"])
def test_a_traced_run_reads_what_the_port_records(cell):
    r = tiny.run(cell, traced=True)
    assert r["correct"] is True and list(r)[-1] == "check"
    want = _ours(cell) - CARD
    assert want and want <= set(r["metrics"])
    assert not CARD & set(r["metrics"])
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
    r = tiny.run("clat_student.serve")
    assert set(r["metrics"]) == {
        m["name"] for m in tiny.manifest()["end_to_end"]
        if "clat_student.serve" in m.get("workloads", ["clat_student.serve"])}
    assert "breakdown" not in r


def test_idle_by_span_takes_the_innermost_span_else_the_phase():
    iv, ev = trace.Interval, trace.Event
    tr = trace.Trace(kernels=[iv("k", 1.0, 2.0), iv("k", 4.0, 5.0),
                              iv("k", 7.0, 8.0)],
                     copies=[], phases=[iv("infer_call", 0.0, 6.0),
                                        iv("readback", 6.0, 9.0)],
                     window=(0.0, 9.0), dispatch=1, events=[
        ev("serve.infer", 0.0, 6.0, 1), ev("serve.forward", 2.0, 6.0, 1),
        ev("fusion", 2.5, 3.5, 1), ev("serve.forward", 6.0, 9.0, 2)])
    got = dict(trace.idle_by_span(tr))
    # gaps 0-1, 2-4, 5-7 and 8-9; the last span runs on another thread
    assert got == {"serve.infer": 1.0,
                   "serve.infer/serve.forward/fusion": 2.0,
                   "serve.infer/serve.forward": 2.0, "readback": 1.0}
    assert sum(got.values()) == sum(s for _, s in trace.idle_gaps(tr))
    # past the cap the smallest paths are summed, the seconds kept
    capped = trace.idle_by_span(tr, top=2)
    assert len(capped) == 2 and capped[-1] == ["rest", 4.0]
    assert sum(s for _, s in capped) == sum(got.values())


def _reader(name):
    path = os.path.join(harness.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_copy_in_waits_is_the_share_of_the_windows_chunks_that_waited():
    span = recorder.SpanRecord
    # five chunks, the first a warm-up outside the window of four; two of
    # the window's waited
    spans = [span(i, "serve.infer", 0, 1, None, 1, rid, False)
             for i, rid in enumerate(range(1, 6))]
    counts = {("serve.copy_in_waits", rid): n
              for rid, n in zip(range(1, 6), (1, 0, 1, 0, 1))}
    run = SimpleNamespace(kind="serve", count=4,
                          program=recorder.Recording(spans, counts))
    read = _reader("copy_in_waits.serve")
    assert read(run) == 50.0
    # no counter (the CPU's copy-in keeps none): nothing to read
    run.program = recorder.Recording(spans, {})
    assert read(run) is None


def test_the_entries_keep_the_contract():
    man = tiny.manifest()
    e2e = {m["name"] for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    ours = [m for m in man["per_layer"] if m["name"] in RECORDED]
    assert {m["name"] for m in ours} == RECORDED
    serve = {m["name"] for m in harness.manifest()["per_layer"]}
    assert {n for n in RECORDED if n.endswith(".serve")} <= serve
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
