"""Spans and counters recorded inside the port, read as per-layer metrics.

The port records its own spans and counters
(``multimodal_learning_tpu_torch/utils/logging.py``): the serving call's
copy-in and forward, the model's parts, the train step's phases, the
loader's crops, stacking, pinning and copies.  ``harness.run`` leaves that
recorder off and keeps of the profile only its own ``pb.`` phases.  A run
made through :func:`run` switches the recorder on before the set-up and
collects it after the window, takes the recorder's ``mml.`` ranges (on the
profiler's clock) from the traced block's profile beside the harness's
own, and hands both to the metric readers as ``run.program``
(:class:`Program`); a traced result also gets
``breakdown["idle_by_span"]`` (:func:`idle_by_span`).  The readers of
``ENTRIES`` are ``metrics/<name>.py``, as every metric's.

    python3 perfbench/program.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout prints the result line as ``run.py`` does,
with ``ENTRIES`` read where they apply.  It takes the cells of
``tests/tiny.py:manifest()``: ``BENCHMARK.json``'s and the waiting train
cells, at full size.  With ``--trace 0`` it is ``run.py``'s run with the
recorder on: the recorder's cost.
"""
from __future__ import annotations

import time

T0 = time.time()

import copy  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, NamedTuple, Optional, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import trace as tracing  # noqa: E402

SERVE = ("clat_student.serve", "pofusion_teacher.serve")
TRAIN = ("pofusion_teacher.train", "clat_student.train")
# (name, unit, better, source, layer, moves, cells) of each metric read
# from what the port records
ENTRIES = (
    ("copy_in_ms.serve", "ms", "lower", "program_span", "serving fn",
     "serve_patches_per_s", SERVE),
    ("forward_dispatch_ms.serve", "ms", "lower", "program_span",
     "serving fn", "serve_patches_per_s", SERVE),
    ("copy_in_gbps.serve", "GB/s", "higher", "device_trace", "serving fn",
     "serve_patches_per_s", SERVE),
    ("forward_idle.serve", "%", "lower", "device_trace", "device",
     "serve_patches_per_s", SERVE),
    ("loader_batch_ms.train", "ms", "lower", "program_span",
     "input pipeline", "train_patches_per_s", TRAIN),
    ("batch_ready.train", "%", "higher", "program_counter",
     "input pipeline", "train_patches_per_s", TRAIN),
    ("forward_dispatch_ms.train", "ms", "lower", "program_span",
     "train step", "train_patches_per_s", TRAIN),
    ("backward_dispatch_ms.train", "ms", "lower", "program_span",
     "train step", "train_patches_per_s", TRAIN),
    ("optimizer_dispatch_ms.train", "ms", "lower", "program_span",
     "train step", "train_patches_per_s", TRAIN),
)


class Event(NamedTuple):
    """A recorder span as the profiler drew it: ``mml.<name>`` on a
    thread, in seconds on the profiler's clock."""
    name: str
    start: float
    end: float
    thread: int


class Program(NamedTuple):
    spans: list              # the recorder's SpanRecords, in end order
    counts: Dict             # (name, request id) -> total
    events: List[Event]      # the traced block's spans on the trace clock
    dispatch: Optional[int]  # the profiler's id of the harness's thread


def with_entries(man: Dict) -> Dict:
    """``man`` with ``ENTRIES`` added for the cells it holds."""
    man = copy.deepcopy(man)
    cells = {w["name"] for w in man["workloads"]}
    have = {m["name"] for m in man["per_layer"]}
    for name, unit, better, source, layer, moves, on in ENTRIES:
        if name in have or not cells & set(on):
            continue
        man["per_layer"].append({
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": moves,
            "workloads": [c for c in on if c in cells]})
    return man


def events(prof) -> Tuple[List[Event], Optional[int]]:
    """The recorder's ranges in a stopped ``torch.profiler.profile``, and
    the profiler's id of the thread that ran the harness's phases."""
    out, dispatch = [], None
    for ev in prof.profiler.kineto_results.events():
        if tracing._is_device(ev):
            continue
        name = ev.name()
        if name.startswith("mml."):
            start, end = tracing._times(ev)
            out.append(Event(name[4:], start, end, ev.start_thread_id()))
        elif name.startswith(tracing.PREFIX) and dispatch is None:
            dispatch = ev.start_thread_id()
    return out, dispatch


def requests(prog: Program, root: str, n: int) -> List[int]:
    """The request ids of the last ``n`` spans named ``root``: the
    window's chunks (``serve.infer``) or steps (``step.forward``)."""
    rids: List[int] = []
    for s in prog.spans:
        if s.name == root and (not rids or rids[-1] != s.rid):
            rids.append(s.rid)
    return rids[-n:] if n > 0 else []


def ms_per_request(prog: Program, rids: List[int], names) -> Optional[float]:
    """The mean over ``rids`` of the milliseconds of their spans named in
    ``names``, summed per request."""
    if not rids:
        return None
    want = set(rids)
    ns = sum(s.end_ns - s.start_ns for s in prog.spans
             if s.rid in want and s.name in names)
    return ns * 1e-6 / len(rids)


def _gaps(tr) -> List[Tuple[float, float]]:
    """The device's idle intervals in the window, as ``trace.idle_gaps``
    takes them."""
    lo, hi = tr.window
    gaps, t = [], lo
    for s, e in tracing.busy_intervals(tr):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _stacks(intervals, points: List[float]) -> List[list]:
    """For each of the ascending ``points``, the ``intervals`` (each with
    ``start`` and ``end``, nested as one thread's spans are) that hold
    it, outermost first."""
    ivs = sorted(intervals, key=lambda x: (x.start, -x.end))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(ivs) and ivs[i].start <= p:
            while stack and stack[-1].end < ivs[i].start:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1].end < p:
            stack.pop()
        out.append([x for x in stack if x.end >= p])
    return out


def idle_by_span(tr, prog: Program) -> List[List]:
    """The device's idle seconds in the traced window by the innermost
    program span of the dispatching thread at each gap's midpoint, named
    by its path (``serve.infer/serve.forward/fusion``); a gap in no
    program span falls under the harness phase it lies in, as in
    ``trace.idle_gaps`` (``other`` where none).  The largest first; the
    same seconds in all as ``idle_gaps``."""
    gaps = _gaps(tr)
    mids = [0.5 * (s + e) for s, e in gaps]
    mine = [e for e in prog.events if e.thread == prog.dispatch]
    spans = _stacks(mine, mids)
    phases = _stacks(tr.phases, mids)
    totals: Dict[str, float] = {}
    for (s, e), held, ph in zip(gaps, spans, phases):
        where = ("/".join(x.name for x in held) if held
                 else ph[-1].name if ph else "other")
        totals[where] = totals.get(where, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]


def run(workload: str, seed: int, seconds: float, traced: bool,
        man: Dict, **kw) -> Dict:
    """``harness.run`` of a cell of ``man`` with the port's recorder on
    (``kw`` as ``harness.run`` takes them); ``ENTRIES`` are read where
    ``man`` holds their cells."""
    from unittest import mock

    from multimodal_learning_tpu_torch.utils import logging as recorder
    from perfbench import harness

    seen: Dict = {}

    def parse(prof):
        seen["events"], seen["dispatch"] = events(prof)
        seen["trace"] = parse_harness(prof)
        return seen["trace"]

    def program() -> Program:
        if "program" not in seen:
            got = recorder.collect()
            seen["program"] = Program(got.spans, got.counts,
                                      seen.get("events", []),
                                      seen.get("dispatch"))
        return seen["program"]

    def readers(man_, cell, traced_):
        def give(read):
            def read_with(run_):
                run_.program = program()
                return read(run_)
            return read_with
        return [(m, give(read))
                for m, read in readers_harness(man_, cell, traced_)]

    parse_harness, readers_harness = tracing.parse, harness._readers
    recorder.enable()
    try:
        with mock.patch.object(tracing, "parse", parse), \
                mock.patch.object(harness, "_readers", readers):
            result = harness.run(workload, seed, seconds, traced,
                                 man=with_entries(man), **kw)
    finally:
        program()
    if "breakdown" in result and seen.get("trace") is not None:
        result["breakdown"]["idle_by_span"] = idle_by_span(
            seen["trace"], program())
    return result


def main(argv=None) -> int:
    import argparse
    import json

    from perfbench import run as run_py   # its caches and bytecode set-up

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness
    from perfbench.tests import tiny

    if not torch.cuda.is_available():
        print("perfbench: program.py needs a CUDA device", file=sys.stderr)
        return 2
    keep: Dict = {}
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 tiny.manifest(), device="cuda",
                 t0=harness.process_start() or T0, keep=keep)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    print(json.dumps(run_py._plain(result)))
    win = keep["window"]
    print(f"window: {win['count']} in {win['seconds']:.3f} s; mean ms " +
          ", ".join(f"{k} {v:.3f}" for k, v in win["ms"].items()),
          file=sys.stderr)
    for name, n in result["check"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
