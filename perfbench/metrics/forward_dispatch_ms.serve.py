"""Host ms per chunk in the serving call's ``serve.forward``: the eval
forward's dispatch, the mean over every chunk of the window.  Recorded
inside the port, in traced runs."""
from perfbench import trace


def read(run):
    prog = run.program
    if run.kind != "serve" or prog is None:
        return None
    return trace.ms_per_request(
        prog, trace.requests(prog, "serve.infer", run.count),
        ("serve.forward",))
