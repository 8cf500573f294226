"""The serving copy-in's rate on the device: the port's counter
``serve.copy_in_bytes`` over the traced block's chunks, over the device
seconds of the host-to-device copies in the traced block, in GB/s."""


def read(run):
    prog, t = run.program, run.trace
    if run.kind != "serve" or prog is None or t is None:
        return None
    lo, hi = t.window
    secs = sum(min(c.end, hi) - max(c.start, lo) for c in t.copies
               if "HtoD" in c.name and c.end > lo and c.start < hi)
    traced = {s.rid for s in prog.spans if s.name == "serve.infer"
              and s.traced}
    nbytes = sum(n for (name, rid), n in prog.counts.items()
                 if name == "serve.copy_in_bytes" and rid in traced)
    if secs <= 0 or not nbytes:
        return None
    return nbytes / secs / 1e9
