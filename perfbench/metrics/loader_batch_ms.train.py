"""Host ms per batch of the loader's work on it, on its own threads:
``loader.crops`` + ``loader.stack`` + ``prefetch.pin`` + ``prefetch.copy``,
the mean over the batches the window's steps ran on.  Recorded inside the
port, in traced runs."""
from perfbench import trace


def read(run):
    prog = run.program
    if run.kind != "train" or prog is None:
        return None
    return trace.ms_per_request(
        prog, trace.requests(prog, "step.forward", run.count),
        ("loader.crops", "loader.stack", "prefetch.pin", "prefetch.copy"))
