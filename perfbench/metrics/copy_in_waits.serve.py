"""Share of the window's chunks whose copy-in found the pinned buffer's
previous host-to-device copy still in flight and waited for it: chunks
with the port's counter ``serve.copy_in_waits`` above 0, over the
window's ``serve.infer`` spans, in %.  The counter exists on the card
only (``serve/staging.py:CopyIn``)."""
from perfbench import trace


def read(run):
    prog = run.program
    if run.kind != "serve" or prog is None:
        return None
    rids = trace.requests(prog, "serve.infer", run.count)
    waits = {rid: n for (name, rid), n in prog.counts.items()
             if name == "serve.copy_in_waits"}
    if not rids or not waits.keys() & set(rids):
        return None
    return 100.0 * sum(1 for rid in rids if waits.get(rid, 0) > 0) / len(rids)
