"""Host ms per train step in its ``step.forward``, the mean over every
step of the window.  The step makes no host synchronisation, so this is
dispatch.  Recorded inside the port, in traced runs."""
from perfbench import trace


def read(run):
    prog = run.program
    if run.kind != "train" or prog is None:
        return None
    return trace.ms_per_request(
        prog, trace.requests(prog, "step.forward", run.count),
        ("step.forward",))
