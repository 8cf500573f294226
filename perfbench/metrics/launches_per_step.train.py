"""Kernel launches per train step in the traced block, from the
profiler's CUDA activity (kernels only; copies and sets not counted)."""
from perfbench import trace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.kernels:
        return None
    steps = trace.count(t, "step_call")
    return len(trace.kernels_named(t, "")) / steps if steps else None
