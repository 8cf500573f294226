"""Reading a ``torch.profiler`` trace of the traced block of a window.

The harness wraps each phase of its loop in ``record_function("pb.<phase>")``
and profiles a block of steps or chunks with CPU and CUDA activity.  From
the raw Kineto events this takes the device's activity (kernels, copies
and sets), the union of its intervals (busy time), the idle gaps between
them and which of the harness's phases the host was in at each gap, and
the kernels by name.  The busy-time and top-kernel arithmetic is that of
the port's on-chip smoke test (``_profile_steps``), here over explicit
intervals so that overlapping kernels are not counted twice.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

PREFIX = "pb."


class Interval(NamedTuple):
    name: str
    start: float     # seconds, on the profiler's clock
    end: float


class Trace(NamedTuple):
    kernels: List[Interval]
    copies: List[Interval]
    phases: List[Interval]       # the harness's record_function spans
    window: Tuple[float, float]

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
    harness's phases, the optimizer's step) is also drawn on the device's
    timeline under its own name; those copies are not device work."""
    events = prof.profiler.kineto_results.events()
    host_names = {ev.name() for ev in events if not _is_device(ev)}
    kernels, copies, phases = [], [], []
    for ev in events:
        name = ev.name()
        start, end = _times(ev)
        if not _is_device(ev):
            if name.startswith(PREFIX):
                phases.append(Interval(name[len(PREFIX):], start, end))
        elif name not in host_names:
            lower = name.lower()
            bucket = copies if lower.startswith(("memcpy", "memset")) \
                else kernels
            bucket.append(Interval(name, start, end))
    if not phases:
        return None
    window = (min(p.start for p in phases), max(p.end for p in phases))
    return Trace(kernels, copies, phases, window)


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


def idle_gaps(tr: Trace, top: int = 10) -> List[List]:
    """The device's idle time inside the window, by the harness phase the
    host was in at the middle of each gap (``other`` where none was),
    the largest totals first."""
    lo, hi = tr.window
    busy = busy_intervals(tr)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    phases = sorted(tr.phases, key=lambda p: p.start)
    totals: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
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
