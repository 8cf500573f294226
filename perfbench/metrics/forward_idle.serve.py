"""Share of the traced block in which the device sat idle while the
dispatching thread was inside the serving call's ``serve.forward`` or a
span within it (gaps placed by their midpoint, as
``breakdown.idle_by_span``), in %."""
from perfbench import trace


def read(run):
    t = run.trace
    if run.kind != "serve" or run.program is None or t is None \
            or not (t.kernels or t.copies) or not t.events:
        return None
    idle = sum(s for path, s in trace.idle_by_span(t, top=None)
               if "serve.forward" in path.split("/"))
    return 100.0 * idle / t.window_s
