"""Host ms per chunk in the serving call's ``serve.forward``: the eval
forward's dispatch, the mean over every chunk of the window.  Recorded
inside the port (``perfbench/program.py``)."""
from perfbench import program


def read(run):
    prog = getattr(run, "program", None)
    if run.kind != "serve" or prog is None:
        return None
    return program.ms_per_request(
        prog, program.requests(prog, "serve.infer", run.count),
        ("serve.forward",))
