"""Structured observability: the per-epoch metrics log, and the spans and
counters recorded inside the port.

``MetricsLogger`` is the port's copy of the JAX package's: every epoch
appends one JSON line to ``<ckpt_dir>/metrics.jsonl``.

The recorder times the port's layers where the work happens.
``span(name)`` is a context manager around a block and ``count(name, n)``
adds to a counter.  It records only between ``enable()`` and
``collect()``, which returns what it holds and switches it off; nothing
else switches it on.  Off, ``span`` reads one module flag and returns a
shared no-op context manager, and ``count`` returns at once.  On, each
span keeps, in memory, its name, start and end (``time.perf_counter_ns``),
its parent (the span its thread was inside), its thread and the id of its
request; while a ``torch.profiler`` runs on its thread it also opens
``torch.profiler.record_function("mml.<name>")``, so that it lies in the
profiler's trace beside the device's work, on that trace's clock.  While
``torch.export`` or ``torch.compile`` traces, a span is a no-op, so an
exported graph holds no profiler op.

Requests: ``new_request()`` gives the calling thread a new id and
``bind(rid)`` hands it one that another thread drew; a span and a count
take the id their thread holds when they end.  A served chunk is one
request (``serve/export.py:make_infer_fn``); a train batch is one, from
the loader thread that builds it through the consumer's wait for it to
the step that runs on it (``data/pipeline.py``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "mml."


class MetricsLogger:
    """Appends one JSON line per ``log``; with ``enabled=False`` (a
    data-parallel rank other than 0) it writes nothing."""

    def __init__(self, ckpt_dir: str, run_name: str = "train",
                 enabled: bool = True):
        self.enabled = enabled
        if enabled:
            os.makedirs(ckpt_dir, exist_ok=True)
        self.path = os.path.join(ckpt_dir, "metrics.jsonl")
        self.run_name = run_name
        self.t0 = time.time()

    def log(self, record: Dict) -> None:
        if not self.enabled:
            return
        rec = {"run": self.run_name,
               "wall_s": round(time.time() - self.t0, 2)}
        for k, v in record.items():
            try:
                rec[k] = float(v) if hasattr(v, "__float__") else v
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


class SpanRecord(NamedTuple):
    sid: int
    name: str
    start_ns: int            # time.perf_counter_ns
    end_ns: int
    parent: Optional[int]    # sid of the span its thread was inside
    thread: int              # threading.get_ident()
    rid: Optional[int]       # the request its thread held at its end
    traced: bool             # also a record_function in a profiler's trace


class Recording(NamedTuple):
    spans: List[SpanRecord]                          # in the order they ended
    counts: Dict[Tuple[str, Optional[int]], int]     # (name, rid) -> total


_on = False
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_spans: List[SpanRecord] = []
_counts: Dict[Tuple[str, Optional[int]], int] = {}
_sids = itertools.count(1)
_rids = itertools.count(1)


def enable() -> None:
    """Start recording, from nothing."""
    global _on, _spans, _counts
    with _lock:
        _spans, _counts = [], {}
        _on = True


def collect() -> Recording:
    """Stop recording; what was recorded since ``enable()``."""
    global _on, _spans, _counts
    with _lock:
        _on = False
        out = Recording(_spans, _counts)
        _spans, _counts = [], {}
    return out


def new_request() -> Optional[int]:
    """A new request id, held by the calling thread from now on."""
    if not _on:
        return None
    rid = next(_rids)
    _local.rid = rid
    return rid


def bind(rid: Optional[int]) -> None:
    """The calling thread works for request ``rid`` from now on."""
    if _on:
        _local.rid = rid


def bound() -> Optional[int]:
    """The request the calling thread works for."""
    return getattr(_local, "rid", None) if _on else None


def count(name: str, n: int = 1) -> None:
    if not _on:
        return
    key = (name, getattr(_local, "rid", None))
    with _lock:
        _counts[key] = _counts.get(key, 0) + int(n)


def span(name: str):
    """A context manager that records the block it wraps as ``name``."""
    if not _on or torch.compiler.is_compiling():
        return _NOOP
    return _Span(name)


class _Span:
    __slots__ = ("name", "sid", "parent", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.sid = next(_sids)
        stack.append(self.sid)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        if _on:
            _spans.append(SpanRecord(
                self.sid, self.name, self.start, end, self.parent,
                threading.get_ident(), getattr(_local, "rid", None),
                self.rf is not None))
        return False
