"""Share of the window's batches that the ``PrefetchLoader`` had already
queued when the step asked for them: the port's counters
``prefetch.ready`` over ``prefetch.gets``, in %."""
from perfbench import trace


def read(run):
    prog = run.program
    if run.kind != "train" or prog is None:
        return None
    rids = set(trace.requests(prog, "step.forward", run.count))
    got = {name: sum(n for (k, rid), n in prog.counts.items()
                     if k == name and rid in rids)
           for name in ("prefetch.gets", "prefetch.ready")}
    if not got["prefetch.gets"]:
        return None
    return 100.0 * got["prefetch.ready"] / got["prefetch.gets"]
