"""Share of the traced block in which no kernel, copy or set ran on the
device (the union of the CUDA activity's intervals), in %."""
from perfbench import trace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not (t.kernels or t.copies):
        return None
    return 100.0 * (1.0 - trace.busy_s(t) / t.window_s)
