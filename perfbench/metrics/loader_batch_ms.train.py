"""Host ms per batch of the loader's work on it, on its own threads:
``loader.crops`` + ``loader.stack`` + ``prefetch.pin`` + ``prefetch.copy``,
the mean over the batches the window's steps ran on.  Recorded inside the
port (``perfbench/program.py``)."""
from perfbench import program


def read(run):
    prog = getattr(run, "program", None)
    if run.kind != "train" or prog is None:
        return None
    return program.ms_per_request(
        prog, program.requests(prog, "step.forward", run.count),
        ("loader.crops", "loader.stack", "prefetch.pin", "prefetch.copy"))
