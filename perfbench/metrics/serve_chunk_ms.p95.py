"""The 95th percentile over every chunk of the window of one chunk's
time, from handing its host arrays to ``infer`` until its outputs are
numpy on the host, in ms."""
import numpy as np


def read(run):
    chunks = run.spans.get("chunk")
    if run.kind != "serve" or not chunks:
        return None
    return float(np.percentile(np.asarray(chunks) * 1e3, 95))
