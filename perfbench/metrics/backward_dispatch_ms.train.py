"""Host ms per train step in its ``step.backward``, the mean over every
step of the window.  The step makes no host synchronisation, so this is
dispatch.  Recorded inside the port (``perfbench/program.py``)."""
from perfbench import program


def read(run):
    prog = getattr(run, "program", None)
    if run.kind != "train" or prog is None:
        return None
    return program.ms_per_request(
        prog, program.requests(prog, "step.forward", run.count),
        ("step.backward",))
