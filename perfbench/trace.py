"""Reading a ``torch.profiler`` trace of the traced block of a window, and
what the port recorded inside itself.

The harness wraps each phase of its loop in ``record_function("pb.<phase>")``
and profiles a block of steps or chunks with CPU and CUDA activity.  From
the raw Kineto events this takes the device's activity (kernels, copies
and sets), the union of its intervals (busy time), the idle gaps between
them and which of the harness's phases the host was in at each gap, and
the kernels by name.  The busy-time and top-kernel arithmetic is that of
the port's on-chip smoke test (``_profile_steps``), here over explicit
intervals so that overlapping kernels are not counted twice.

In a traced run the port's recorder
(``multimodal_learning_tpu_torch/utils/logging.py``) is on: its spans also
lie in the profile as ``mml.<name>`` ranges, which :func:`parse` keeps with
their threads and the thread of the harness's phases, and its
``Recording`` (every span and counter from set-up to the window's end) is
what the readers get as ``run.program``: :func:`requests`,
:func:`ms_per_request` and :func:`idle_by_span` read them.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

PREFIX = "pb."
PROGRAM_PREFIX = "mml."


class Interval(NamedTuple):
    name: str
    start: float     # seconds, on the profiler's clock
    end: float


class Event(NamedTuple):
    """A span of the port's recorder as the profiler drew it: ``mml.<name>``
    on a thread, in seconds on the profiler's clock."""
    name: str
    start: float
    end: float
    thread: int


class Trace(NamedTuple):
    kernels: List[Interval]
    copies: List[Interval]
    phases: List[Interval]       # the harness's record_function spans
    window: Tuple[float, float]
    events: List[Event]          # the port's spans
    dispatch: Optional[int]      # the thread of the harness's phases

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _times(ev) -> Tuple[float, float]:
    if hasattr(ev, "start_ns"):
        start, dur = ev.start_ns(), ev.duration_ns()
        return start * 1e-9, (start + dur) * 1e-9
    start, dur = ev.start_us(), ev.duration_us()
    return start * 1e-6, (start + dur) * 1e-6


def _is_device(ev) -> bool:
    kind = str(ev.device_type()).rsplit(".", 1)[-1]
    return kind in ("CUDA", "PrivateUse1")


def parse(prof) -> Optional[Trace]:
    """The trace of a stopped ``torch.profiler.profile``; None when it
    holds no phase of the harness.  A ``record_function`` range (the
    harness's phases, the port's spans, the optimizer's step) is also
    drawn on the device's timeline under its own name; those copies are
    not device work."""
    events = prof.profiler.kineto_results.events()
    host_names = {ev.name() for ev in events if not _is_device(ev)}
    kernels, copies, phases, spans = [], [], [], []
    dispatch = None
    for ev in events:
        name = ev.name()
        start, end = _times(ev)
        if not _is_device(ev):
            if name.startswith(PREFIX):
                phases.append(Interval(name[len(PREFIX):], start, end))
                if dispatch is None:
                    dispatch = ev.start_thread_id()
            elif name.startswith(PROGRAM_PREFIX):
                spans.append(Event(name[len(PROGRAM_PREFIX):], start, end,
                                   ev.start_thread_id()))
        elif name not in host_names:
            lower = name.lower()
            bucket = copies if lower.startswith(("memcpy", "memset")) \
                else kernels
            bucket.append(Interval(name, start, end))
    if not phases:
        return None
    window = (min(p.start for p in phases), max(p.end for p in phases))
    return Trace(kernels, copies, phases, window, spans, dispatch)


def _clip(iv: List[Interval], lo: float, hi: float) -> List[Tuple]:
    out = []
    for x in iv:
        s, e = max(x.start, lo), min(x.end, hi)
        if e > s:
            out.append((s, e))
    return sorted(out)


def busy_intervals(tr: Trace) -> List[Tuple[float, float]]:
    """The union of the device's kernels and copies inside the window."""
    merged: List[List[float]] = []
    for s, e in _clip(tr.kernels + tr.copies, *tr.window):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr))


def _gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the window."""
    lo, hi = tr.window
    gaps, t = [], lo
    for s, e in busy_intervals(tr):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_gaps(tr: Trace, top: int = 10) -> List[List]:
    """The device's idle time inside the window, by the harness phase the
    host was in at the middle of each gap (``other`` where none was),
    the largest totals first."""
    phases = sorted(tr.phases, key=lambda p: p.start)
    totals: Dict[str, float] = defaultdict(float)
    for s, e in _gaps(tr):
        mid = 0.5 * (s + e)
        where = "other"
        for p in phases:
            if p.start <= mid <= p.end:
                where = p.name
        totals[where] += e - s
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            ][:top]


def device_ops(tr: Trace, top: int = 10) -> List[List]:
    """Device time by kernel or copy name inside the window, the largest
    first."""
    lo, hi = tr.window
    totals: Dict[str, float] = defaultdict(float)
    for x in tr.kernels + tr.copies:
        s, e = max(x.start, lo), min(x.end, hi)
        if e > s:
            totals[x.name[:120]] += e - s
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            ][:top]


def kernels_named(tr: Trace, *tags: str) -> List[Interval]:
    """The window's kernels whose name holds one of ``tags``."""
    lo, hi = tr.window
    return [k for k in tr.kernels if lo <= k.start and k.end <= hi
            and any(t in k.name for t in tags)]


def count(tr: Trace, phase: str) -> int:
    return sum(1 for p in tr.phases if p.name == phase)


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


def idle_by_span(tr: Trace, top: Optional[int] = 10) -> List[List]:
    """The device's idle seconds in the window by the innermost span of the
    port on the dispatching thread at each gap's midpoint, named by its
    path (``serve.infer/serve.forward/fusion``); a gap in no span of the
    port falls under the harness phase it lies in, as in
    :func:`idle_gaps` (``other`` where none).  The largest first; past
    ``top - 1`` paths (None: no cap) the rest are summed under ``rest``,
    so that the seconds add up to those of every gap."""
    gaps = _gaps(tr)
    mids = [0.5 * (s + e) for s, e in gaps]
    mine = [e for e in tr.events if e.thread == tr.dispatch]
    totals: Dict[str, float] = defaultdict(float)
    for (s, e), held, ph in zip(gaps, _stacks(mine, mids),
                                _stacks(tr.phases, mids)):
        where = ("/".join(x.name for x in held) if held
                 else ph[-1].name if ph else "other")
        totals[where] += e - s
    out = [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
    if top is not None and len(out) > top:
        out = out[:top - 1] + [["rest", sum(v for _, v in out[top - 1:])]]
    return out


def requests(rec, root: str, n: int) -> List[int]:
    """The request ids of the last ``n`` spans named ``root`` in the
    recording ``rec``: the window's chunks (``serve.infer``) or steps
    (``step.forward``)."""
    rids: List[int] = []
    for s in rec.spans:
        if s.name == root and (not rids or rids[-1] != s.rid):
            rids.append(s.rid)
    return rids[-n:] if n > 0 else []


def ms_per_request(rec, rids: List[int], names) -> Optional[float]:
    """The mean over ``rids`` of the milliseconds of their spans named in
    ``names``, summed per request."""
    if not rids:
        return None
    want = set(rids)
    ns = sum(s.end_ns - s.start_ns for s in rec.spans
             if s.rid in want and s.name in names)
    return ns * 1e-6 / len(rids)
