"""Structured observability.

The port's copy of ``MetricsLogger`` and ``StepTimer`` from
``multimodal_learning_tpu/utils/logging.py``: every epoch appends one JSON
line to ``<ckpt_dir>/metrics.jsonl``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


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


class StepTimer:
    """Steady-state steps/sec with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.start = None

    def tick(self):
        self.count += 1
        if self.count == self.warmup:
            self.start = time.perf_counter()

    def rate(self, items_per_step: int = 1) -> float:
        if self.start is None or self.count <= self.warmup:
            return 0.0
        dt = time.perf_counter() - self.start
        return (self.count - self.warmup) * items_per_step / max(dt, 1e-9)
